"""The port's benchmark harness (``caf_cookoff_tpu_torch.utils.
bench_configs``) on the CPU: its inputs against the JAX harnesses'
numpy recipes byte for byte, every cell's gate at a reduced size, the
gate refusing a wrong truth before anything is timed, the refusal to
time anywhere but on a CUDA card, and the lines' fields with a stub
timer.  Timing itself needs the card (``tests/test_torch_cuda.py``).

The recipes come from the JAX harnesses: ``bench_configs.py``'s
``_rand_pair`` (the root module imports no JAX at import time) and, for
the recipes written inline in functions that run JAX, their numpy lines
repeated here.  config5's gate starts the file's one gloo world (8
small ranks).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.config import BENCH_GRID as JBENCH_GRID
from caf_cookoff_tpu.config import FreqGrid as JFreqGrid
from caf_cookoff_tpu.utils.io import load_c64 as jload_c64
from caf_cookoff_tpu_torch.config import FreqGrid
from caf_cookoff_tpu_torch.utils import bench_configs as bc

from test_torch_fixtures import fixture_pairs  # noqa: E402,F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import bench_configs as jbc  # noqa: E402  (the JAX harness, numpy only)

torch.set_num_threads(1)

FS = 48_000.0


def _same(got, want):
    """Equal byte for byte (arrays: dtype, shape, bytes), recursively."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


# --- the recipes, as the JAX harnesses (and stream3's/lattice2's source)
# write them ---------------------------------------------------------------


def _jax_config2():
    b, n = 64, 4096
    needles = np.stack([jbc._rand_pair(n, 50 + i, 10.0 * i - 300, i)[0]
                        for i in range(b)])
    hays = np.stack([jbc._rand_pair(n, 50 + i, 10.0 * i - 300, i)[1]
                     for i in range(b)])
    return needles, hays, JBENCH_GRID.frequencies(np.float32), None, None


def _jax_config3():
    n, lags, k = 4096, 65536, 2000
    needle, _ = jbc._rand_pair(n, 7, 0.0, 0)
    rng = np.random.default_rng(1)
    hay = (rng.standard_normal(lags + n)
           + 1j * rng.standard_normal(lags + n)).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    true_f, true_lag = float(freqs_np[1234]), 30_000
    t = np.arange(n)
    hay[true_lag:true_lag + n] += 3 * (needle * np.exp(
        2j * np.pi * true_f * t / FS)).astype(np.complex64)
    return needle[None], hay[None], freqs_np, lags, [(true_f, true_lag)]


def _jax_config4():
    pairs, n, lags, k = 16, 4096, 32768, 1024
    rng = np.random.default_rng(2)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n))
                    )).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    emitters = []
    for b in range(pairs):
        lag = 777 + b * 2011
        f_hz = float(freqs_np[61 * (b + 1)])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)[: lags + n - lag]
        emitters.append((f_hz, lag))
    return needles, hays, freqs_np, lags, emitters


def _jax_config5():
    pairs, n, lags, k = 8, 1024, 16_384, 64
    rng = np.random.default_rng(4)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n))
                    )).astype(np.complex64)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    emitters = []
    for b in range(pairs):
        lag = 500 + b * 1777
        f_hz = float(freqs_np[5 + 7 * b])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)
        emitters.append((f_hz, lag))
    return needles, hays, freqs_np, lags, emitters


def _smoke_lattice2():
    grid = JBENCH_GRID.frequencies(np.float32)
    rng = np.random.default_rng(3)
    n, t = 4096, np.arange(4096)
    needles = (rng.standard_normal((64, n))
               + 1j * rng.standard_normal((64, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((64, n))
                    + 1j * rng.standard_normal((64, n)))).astype(np.complex64)
    truths2 = []
    for i in range(64):
        es = [(50 + i, 20 + 5 * i, 1.0), (600 + 7 * i, (220 + 5 * i) % 400,
                                          0.7)]
        for lag, k, amp in es:
            hays[i, lag:] += (amp * needles[i, :n - lag] * np.exp(
                2j * np.pi * grid[k] * t[lag:] / FS)).astype(np.complex64)
        truths2.append([(float(grid[k]), lag) for lag, k, _ in es])
    return needles, hays, grid, None, truths2


def _jax_lattice4():
    pairs, n, lags, k = 16, 4096, 32768, 1024
    rng = np.random.default_rng(2)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))
               ).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n))
                    )).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k,
                           endpoint=False).astype(np.float32)
    t = np.arange(n)
    emitters = []
    for b in range(pairs):
        rows = []
        for j, (lag, f_idx, amp) in enumerate((
                (777 + b * 1813, 61 * (b + 1), 1.0),
                (17000 + b * 911, 997 - 53 * b, 0.7))):
            f_hz = float(freqs_np[f_idx])
            hays[b, lag:lag + n] += (amp * needles[b] * np.exp(
                2j * np.pi * f_hz * t / FS)
            ).astype(np.complex64)[: lags + n - lag]
            rows.append((f_hz, lag))
        emitters.append(rows)
    return needles, hays, freqs_np, lags, emitters


def _jax_rate3():
    n, lags, k = 4096, 65536, 2000
    rates_np = np.arange(-200.0, 201.0, 50.0, dtype=np.float32)  # R=9
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(lags + n)
                   + 1j * rng.standard_normal(lags + n))
           ).astype(np.complex64)
    freqs_np = np.linspace(-500, 500, k,
                           endpoint=False).astype(np.float32)
    t = np.arange(n)
    true_f, true_r, true_lag = float(freqs_np[1234]), 150.0, 30_000
    ph = 2 * np.pi * true_f * t / FS + np.pi * true_r * (t / FS) ** 2
    hay[true_lag:true_lag + n] += 3 * (needle * np.exp(1j * ph)
                                       ).astype(np.complex64)
    return needle, hay, freqs_np, rates_np, lags, [(true_r, true_f,
                                                    true_lag)]


def _smoke_ratelat3():
    needle, hay, freqs, rates, lags, (e1,) = _jax_rate3()
    n, t = len(needle), np.arange(len(needle))
    hay = hay.copy()
    e2 = (-100.0, float(freqs[345]), 12_000)
    ph = 2 * np.pi * e2[1] * t / FS + np.pi * e2[0] * (t / FS) ** 2
    hay[e2[2]:e2[2] + n] += 1.5 * (needle * np.exp(1j * ph)).astype(
        np.complex64)
    return needle, hay, freqs, rates, lags, [e1, e2]


def _smoke_stream3():
    needles, hays, freqs, _, truths = _jax_config3()
    needle, hay = needles[0], hays[0]
    n = len(needle)
    f2, lag2 = float(freqs[345]), 12_000
    two = hay.copy()
    two[lag2:lag2 + n] += 1.5 * (needle * np.exp(
        2j * np.pi * f2 * np.arange(n) / FS)).astype(np.complex64)
    return needle, hay, two, freqs, truths[0], [truths[0], (f2, lag2)]


RECIPES = {
    "config2": (bc.build_config2, _jax_config2),
    "config3": (bc.build_config3, _jax_config3),
    "config4": (bc.build_config4, _jax_config4),
    "config5": (bc.build_config5, _jax_config5),
    "lattice2": (bc.build_lattice2, _smoke_lattice2),
    "lattice4": (bc.build_lattice4, _jax_lattice4),
    "rate3": (lambda: bc.build_rate3()["rate3"], _jax_rate3),
    "ratelat3": (lambda: bc.build_rate3()["ratelat3"], _smoke_ratelat3),
    "stream3": (bc.build_stream3, _smoke_stream3),
}


@pytest.mark.parametrize("cell", sorted(RECIPES))
def test_builder_is_the_recipe_byte_for_byte(cell):
    build, recipe = RECIPES[cell]
    _same(build(), recipe())


def test_fixture_cells_are_bench_py_s_inputs(fixture_pairs):
    """config1 (``bench.py``) and wide1000 read chirp_0 as the JAX
    harness reads it, on its grids."""
    data_dir = pathlib.Path(fixture_pairs[0][0]).parent
    needle, hay, freqs = bc.build_config1(data_dir)
    n_path, h_path = fixture_pairs[0]
    jneedle = jload_c64(n_path)
    _same((needle, hay, freqs),
          (jneedle, jload_c64(h_path, count=len(jneedle)),
           JBENCH_GRID.frequencies(np.float32)))
    cell = bc.cell_wide1000(torch.device("cpu"), data_dir=data_dir)
    assert cell.shape == "400x8192" and cell.reduced == []
    _same(FreqGrid(-1000.0, 1000.0, 5.0).frequencies(np.float32),
          JFreqGrid(-1000.0, 1000.0, 5.0).frequencies(np.float32))


# --- gates at a reduced size ---------------------------------------------

def _small(data_dir):
    """Shapes small enough for the CPU; every cell's truths stay inside
    them (the builders move the recipe's positions with the shape)."""
    return {
        "config1": {"data_dir": data_dir},
        "config2": {"pairs": 14, "n": 1024},
        "config3": {"n": 1024, "lags": 8192, "k": 200},
        "config4": {"pairs": 2, "n": 1024, "lags": 8192, "k": 128},
        "config5": {"pairs": 2, "n": 256, "lags": 2048, "k": 16},
        "lattice2": {"pairs": 2, "n": 1024},
        "lattice4": {"pairs": 2, "n": 1024, "lags": 8192, "k": 128},
        # The rate cells keep n = 4096: a shorter window no longer tells
        # the 50 Hz/s trial rates apart (its rate cell is ~1/T^2).
        "rate3": {"lags": 4096, "k": 100},
        "ratelat3": {"lags": 4096, "k": 100},
        "stream3": {"n": 1024, "lags": 8192, "k": 200, "chunk": 2048},
        "wide1000": {"step_hz": 10.0, "data_dir": data_dir},
        "stream1000": {"n": 1024, "lags": 8192, "k": 200, "bins": 400,
                       "chunk": 2048},
    }


@pytest.fixture(scope="module")
def small(fixture_pairs):
    return _small(pathlib.Path(fixture_pairs[0][0]).parent)


@pytest.mark.parametrize("name", list(bc.CELLS))
def test_gate_passes_at_a_reduced_size(small, name):
    cell = bc.build_cells([name], "cpu", small)[0]
    assert cell.reduced or name == "config1"
    cell.gate()
    lines = bc.gate_only([cell])
    assert lines[0]["gate"] == "passed" and lines[0]["timed"] is False


def _corrupt(builder, shift):
    @functools.wraps(builder)
    def corrupted(*args, **kw):
        out = builder(*args, **kw)
        return shift(out)
    return corrupted


CORRUPT = {
    "config3": ("build_config3", lambda o: o[:4] + ([(o[4][0][0],
                                                      o[4][0][1] + 5)],)),
    "config4": ("build_config4", lambda o: o[:4] + (
        [(f + 1.0, lag) for f, lag in o[4]],)),
    "lattice4": ("build_lattice4", lambda o: o[:4] + (
        [[(f, lag + 3) for f, lag in rows] for rows in o[4]],)),
    "rate3": ("build_rate3", lambda o: {**o, "rate3": o["rate3"][:5] + (
        [(100.0,) + o["rate3"][5][0][1:]],)}),
    "stream3": ("build_stream3", lambda o: o[:4] + ((o[4][0], o[4][1] + 1),
                                                    o[5])),
}


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_wrong_truth_is_refused_before_timing(small, monkeypatch, name):
    attr, shift = CORRUPT[name]
    monkeypatch.setattr(bc, attr, _corrupt(getattr(bc, attr), shift))
    timed = []
    cells = bc.build_cells([name], "cpu", small)
    with pytest.raises(bc.GateError, match=name):
        bc.measure(cells, 2, warmup=0,
                   timer=lambda fn: timed.append(fn) or 1.0,
                   work=lambda fn: (0.5, 3.0, 1.0, 2.0), card="stub")
    assert timed == []


def test_timing_refuses_the_cpu(small):
    cells = bc.build_cells(["config3"], "cpu", small)
    gated = []
    cells[0].gate = lambda: gated.append(1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bc.measure(cells, 2)
    assert gated == []


def test_lines_with_a_stub_timer(small):
    """Every engine of the selected cells in each round, the order rotated
    a step a round; one line per (cell, engine) with its statistics, the
    profiler's numbers, host share and units; gate-only cells untimed."""
    cells = bc.build_cells(["config4", "lattice4", "stream3"], "cpu", small)
    metric_of = {id(e.call): bc._metric(c, e) for c in cells
                 for e in c.engines}
    order, got = [], {}

    def timer(fn):
        order.append(fn)
        ms = float(len(order))
        got.setdefault(metric_of[id(fn)], []).append(ms)
        return ms

    lines = bc.measure(cells, 3, warmup=1, timer=timer,
                       work=lambda fn: (0.5, 7.0, 1.0, 2.0),
                       card="stub card")
    engines = [e.call for c in cells for e in c.engines]
    assert len(engines) == 6 and len(lines) == 6
    assert order[:6] == engines
    assert order[6:12] == engines[1:] + engines[:1]
    assert order[12:] == engines[2:] + engines[:2]
    for line in lines:
        ms = got[line["metric"]]
        assert line["metric"].startswith(f"cuda_{line['cell']}_")
        assert line["metric"].endswith(f"_{line['engine']}_call_ms")
        assert line["rounds"] == 3 and line["unit"] == "ms"
        assert line["best_ms"] == min(ms)
        assert line["value"] == line["median_ms"] == float(np.median(ms))
        assert line["spread_ms"] == max(ms) - min(ms)
        assert line["device_ms"] == 0.5 and line["device_ops"] == 7.0
        assert line["syncs"] == 1.0 and line["copies"] == 2.0
        assert line["host_share"] == pytest.approx(1 - 0.5 / line["value"])
        assert line["card"] == "stub card" and "commit" in line
        assert line["reduced"] and line["gate"] == "passed"
    by = {ln["metric"]: ln for ln in lines}
    c4 = next(ln for ln in lines if ln["cell"] == "config4")
    assert c4["ms_per_pair"] == c4["value"] / 2
    for ln in by.values():
        if ln["cell"] == "stream3":
            assert ln["samples_per_s"] == pytest.approx(
                9216 / (ln["value"] / 1e3))
    assert {ln["engine"] for ln in lines if ln["cell"] == "lattice4"} == {
        "stein", "cufft_lattice_scan"}
    head = bc.headline({**c4, "value": 2.0})
    assert head["metric"] == "cuda_caf_surface_peak_400x8192_ms"
    assert head["vs_baseline"] == 14.0


def test_lines_count_captures_in_the_timed_rounds(small, monkeypatch):
    """A compiled call that captures during the timed rounds (a key the
    graph cache dropped) shows as a count on its own line."""
    from caf_cookoff_tpu_torch.ops import _graph

    monkeypatch.setattr(_graph, "CAPTURES", _graph.CAPTURES)
    cells = bc.build_cells(["config3", "stream3"], "cpu", small)
    evicted = cells[1].engines[0].call

    def timer(fn):
        if fn is evicted:
            _graph.CAPTURES += 1
        return 1.0

    lines = bc.measure(cells, 3, warmup=1, timer=timer,
                       work=lambda fn: (0.5, 7.0, 1.0, 2.0), card="stub")
    assert [ln["captures"] for ln in lines] == [0, 3, 0, 0]
