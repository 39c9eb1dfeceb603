"""The port's spans and counters as ``benchmark/program.py`` and the
``graph_copy_mb`` reader read them: on fixed event lists and synthetic
traces worked out by hand, and in whole traced runs on the CPU."""

import pytest
from torch.autograd import DeviceType

from benchmark import program, run, spec
from benchmark import trace as traces
from benchmark.tests.conftest import SMALL, SMALL_WORKLOAD
from benchmark.trace import Trace

SEED = 2 ** 31 + 77
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
READERS = ("idle_share", "kernel_roofline_share", "device_ops_per_search",
           "syncs_per_search")


class _Event:
    def __init__(self, name, dev, start_ns, end_ns):
        self._v = name, dev, start_ns, end_ns

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


class _Profile:
    """What ``trace.from_profiler`` and ``program.collect`` read of a
    finished ``torch.profiler.profile``."""

    def __init__(self, events):
        class Results:
            def events(self):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


# Two searches; times in microseconds from the first event (1000 ns).
BASE = [
    ("bench.search", CPU, 10, 50), ("bench.search", CPU, 50, 100),
    ("bench.search", CUDA, 12, 48),
    ("stein_tile", CUDA, 20, 30), ("Memcpy DtoD", CUDA, 32, 34),
    ("stein_tile", CUDA, 70, 80), ("Memset", CUDA, 85, 86),
    ("cudaStreamSynchronize", CPU, 40, 45), ("aten::copy_", CPU, 0, 2),
]
PORT = [
    ("caf.call", CPU, 11, 49), ("caf.prep", CPU, 11, 15),
    ("caf.graph", CPU, 15, 35), ("caf.graph.copy_in", CPU, 15, 19),
    ("caf.graph.launch", CPU, 19, 22), ("caf.graph.copy_out", CPU, 22, 35),
    ("caf.read", CPU, 36, 48),
    ("caf.call", CPU, 52, 98), ("caf.prep", CPU, 52, 60),
    ("caf.graph", CPU, 60, 75), ("caf.read", CPU, 76, 97),
]


def _events(rows):
    return [_Event(n, d, 1000 * (1 + a), 1000 * (1 + b))
            for n, d, a, b in rows]


class _Cell:
    device = "cuda"
    workload = {"pool": 8}


def _run_data(tr):
    return run.RunData(_Cell(), 1.0, tr.window_s, tr.searches, [], tr,
                       {"least_s": 1e-6})


def _readings(tr):
    return {m: spec.load_module("metrics", m).read(_run_data(tr))
            for m in READERS}


def test_from_profiler_leaves_the_ports_spans_out():
    """The port's host spans change nothing that the trace reader or an
    existing per-layer reader reads."""
    plain = traces.from_profiler(_Profile(_events(BASE)))
    spanned = traces.from_profiler(_Profile(_events(BASE + PORT)))
    assert spanned.ops == plain.ops and spanned.syncs == plain.syncs
    assert spanned.spans == plain.spans
    assert spanned.busy_s == plain.busy_s
    assert spanned.idle_gaps() == plain.idle_gaps()
    assert spanned.device_ops() == plain.device_ops()
    assert _readings(spanned) == _readings(plain)
    assert all(v is not None for v in _readings(plain).values())


def test_collect_reads_the_spans_on_the_traces_clock():
    prof = _Profile(_events(BASE + PORT))
    spans = program.collect(prof)
    tr = traces.from_profiler(prof)
    assert sorted(spans) == sorted({n for n, *_ in PORT})
    assert spans["caf.call"] == [(11e-6, 49e-6), (52e-6, 98e-6)]
    assert spans["caf.graph.launch"] == [(19e-6, 22e-6)]
    assert tr.window == (10e-6, 100e-6)


def _trace_and_program():
    prof = _Profile(_events(BASE + PORT))
    return traces.from_profiler(prof), program.collect(prof)


def test_program_idle_gaps_go_down_to_the_innermost_span():
    """Busy 20-30, 32-34, 70-80, 85-86 in a window 10-100: each gap is
    cut at the spans' edges and each piece goes to the innermost span
    that holds it."""
    tr, spans = _trace_and_program()
    gaps = {n: s for n, s in program.program_idle_gaps(tr, spans)}
    want = {
        program.OUTSIDE: 1 + 1 + 2 + 2,  # 10-11, 49-50, 50-52, 98-100
        "caf.prep": 4 + 8,               # 11-15, 52-60
        "caf.graph.copy_in": 4,          # 15-19
        "caf.graph.launch": 1,           # 19-20
        "caf.graph.copy_out": 2 + 1,     # 30-32, 34-35
        "caf.call": 1 + 1 + 1,           # 35-36, 48-49, 97-98
        "caf.read": 12 + 5 + 11,         # 36-48, 80-85, 86-97
        "caf.graph": 10,                 # 60-70
    }
    assert gaps == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    inner = sum(v for k, v in want.items()
                if k not in program.ROOTS and k != program.OUTSIDE)
    assert program.inner_idle_share(
        program.program_idle_gaps(tr, spans)) == pytest.approx(
            inner / sum(want.values()))


def test_gap_between_searches_and_inside_nested_spans():
    tr = Trace([("k", 0.0, 1.0), ("k", 9.0, 10.0)], [],
               {"search": [(0.0, 4.0), (6.0, 10.0)]})
    spans = {"caf.call": [(0.5, 3.5), (6.5, 9.5)],
             "caf.graph": [(1.0, 3.0)], "caf.graph.copy_in": [(1.5, 2.0)]}
    gaps = dict(program.program_idle_gaps(tr, spans))
    assert gaps == pytest.approx({
        "caf.graph": 1.5, "caf.graph.copy_in": 0.5, "caf.call": 0.5 + 2.5,
        program.OUTSIDE: 0.5 + 0.5, program.BETWEEN: 2.0})
    assert program.inner_idle_share(list(gaps.items())) == pytest.approx(
        2.0 / 6.0)


def test_span_ms_counts_and_chunk_enqueue():
    spans = {"caf.stream.chunk": [(0.0, 4.0), (5.0, 8.0), (20.0, 21.0)],
             "caf.graph.launch": [(1.0, 2.0), (6.0, 6.5), (20.5, 20.6)],
             "caf.read": [(3.0, 4.0), (7.0, 8.0)]}
    window = (0.0, 10.0)
    assert program.span_ms(spans, window, 2, "caf.read") == pytest.approx(
        1e3)
    assert program.span_ms(spans, window, 2, "caf.prep") is None
    assert program.span_counts(spans, window) == {
        "caf.stream.chunk": 2, "caf.graph.launch": 2, "caf.read": 2}
    assert program.chunk_enqueue_ms(spans, window) == pytest.approx(
        (2.0 + 1.5) / 2 * 1e3)
    assert program.chunk_enqueue_ms({"caf.stream.chunk": [(0.0, 1.0)]},
                                    window) is None


@pytest.fixture
def graph(monkeypatch):
    """``ops/_graph``'s counters and kept graphs, set by hand."""
    from caf_cookoff_tpu_torch.ops import _graph

    def set_(captures, replays, copy_in, copy_out, kept):
        monkeypatch.setattr(_graph, "CAPTURES", captures)
        monkeypatch.setattr(_graph, "REPLAYS", replays)
        monkeypatch.setattr(_graph, "COPY_IN_BYTES", copy_in)
        monkeypatch.setattr(_graph, "COPY_OUT_BYTES", copy_out)
        monkeypatch.setattr(_graph, "copy_bytes", lambda: kept)
    return _graph, set_


def test_graph_copy_mb_from_the_totals(graph, monkeypatch):
    """A stream: 9 chunks of one key (a 1000-byte copy in, 100 out) and
    one re-score (500 in, 50 out) a search; 24 searches of set-up, the
    first of which captured both keys, and 100 in the window."""
    _graph, set_ = graph
    searches = 3 * 8 + 100
    replays = searches * 10 - 2
    copy_in = searches * (9 * 1000 + 500) - 1500
    copy_out = searches * (9 * 100 + 50) - 150
    kept = [("step", 1000, 100), ("rescore", 500, 50)]
    reader = spec.load_module("metrics", "graph_copy_mb")

    class Run:
        cell = _Cell()
    Run.searches = 100
    set_(2, replays, copy_in, copy_out, kept)
    assert reader.read(Run) == pytest.approx(10450 / 1e6)
    set_(3, replays, copy_in, copy_out, kept)           # a graph dropped
    assert reader.read(Run) is None
    set_(2, 0, 0, 0, [])                                # nothing replayed
    assert reader.read(Run) is None
    monkeypatch.delattr(_graph, "copy_bytes")           # an older port
    assert reader.read(Run) is None


def _profile(name):
    config = SMALL[spec.load_json("workloads", name)["config"]]
    return program.profile_cell(name, SEED, 0.3, device="cpu", config=config,
                                workload=SMALL_WORKLOAD[name])


@pytest.mark.parametrize("name", ["cookoff.single", "cookoff.batch64",
                                  "widearea.capture"])
def test_profile_cell_on_the_cpu(name):
    """A traced CPU run: one call, one prep and one read a search, no
    graph (the CPU replays none), and the idle time by span."""
    out = _profile(name)
    assert out["correct"] and out["searches"] > 0
    per = out["spans_per_search"]
    assert per == {"caf.call": 1, "caf.prep": 1, "caf.read": 1}
    assert all(out["span_ms"][n] > 0 for n in per)
    names = {n for n, _ in out["program_idle_gaps"]}
    assert {"caf.prep", "caf.read"} <= names
    assert out["replays_in_window"] == 0
    assert out["graph_copy_bytes_a_search"] == 0
    assert out["chunk_enqueue_ms"] is None
    assert "graph_copy_mb" not in out["metrics"]


def test_profile_stream_cell_on_the_cpu():
    out = _profile("widearea.stream")
    assert out["correct"]
    chunks = -(-(4096 + 512 - 1) // 1024)   # small capture, 1024 a chunk
    per = out["spans_per_search"]
    assert per["caf.stream.build"] == per["caf.stream.best"] == 1
    assert per["caf.stream.chunk"] == per["caf.stream.upload"] == chunks
    assert per["caf.read"] == chunks + 1
    assert per["caf.stream.operator"] == 1 and per["caf.prep"] == 1
