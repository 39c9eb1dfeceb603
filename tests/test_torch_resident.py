"""The resident path of ``ops/_graph`` as plain Python, on the CPU.

An :class:`~caf_cookoff_tpu_torch.ops._graph.Occupant` keeps its traced
inputs in its key's graph buffers from one call to the next.  A card is
needed to capture a graph, so a captured key is stood in for here by
:class:`_EagerGraph`, whose replay runs the core eagerly on the buffers
and writes its outputs where the graph would: into its own output
tensors, and each carried one into its input's buffer.  Everything
else is the module's own bookkeeping (``_run``, placement, writes,
switches, counters), driven on CPU tensors: placement, resident
replays, a switch that saves the live occupant's state, the claim of a
collected occupant, and a graph evicted while held.  The card's side is
in ``tests/test_torch_cuda.py``.
"""

import gc

import numpy as np
import pytest
import torch

from caf_cookoff_tpu_torch import StreamingCAF
from caf_cookoff_tpu_torch.ops import _graph

CPU = torch.device("cpu")
N = 6
CARRIED = ((0, 1), (1, 2))      # state' -> state, count' -> count
FRESH = (3,)


@pytest.fixture(autouse=True)
def _own_caches(monkeypatch):
    """Each test's graphs and counters start empty."""
    monkeypatch.setattr(_graph, "_CACHES", {})
    for name in ("CAPTURES", "REPLAYS", "RESIDENT_REPLAYS", "SWITCHES",
                 "COPY_IN_BYTES", "COPY_OUT_BYTES"):
        monkeypatch.setattr(_graph, name, 0)


def _acc(scale, state, count, x, shift: float):
    """A step with a constant, two carried inputs and a fresh one."""
    new = state + scale * x + shift
    return new, count + 1, new.sum().reshape(1)


STATIC = (0.5,)


class _EagerGraph(_graph._Graph):
    """A captured key's CPU stand-in (see the module docstring)."""

    def __init__(self, core, traced, static, carried):
        inputs = tuple(t.clone() for t in traced)
        outputs = tuple(o.clone() for o in core(*inputs, *static))
        super().__init__(self, inputs, outputs, False, (), None, 0.0, 0)
        self.core, self.static, self.carried = core, static, carried

    def replay(self):
        out = self.core(*self.inputs, *self.static)
        for dst, o in zip(self.outputs, out):
            dst.copy_(o)
        for o, i in self.carried:
            self.inputs[i].copy_(out[o])

    def fence(self):
        pass

    def close(self):
        pass


def _start(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(N, generator=g, dtype=torch.float64),     # scale
            torch.rand(N, generator=g, dtype=torch.float64),     # state
            torch.zeros((), dtype=torch.int64),                  # count
            torch.empty(N, dtype=torch.float64)]                 # x


def _chunks(seed, lengths=(N, N, 4, N, 2)):
    g = torch.Generator().manual_seed(100 + seed)
    return [torch.rand(n, generator=g, dtype=torch.float64) for n in lengths]


def _occupant(seed):
    return _graph.Occupant(_acc, _start(seed), STATIC, CARRIED, FRESH)


def _captured(seed=9):
    """A graph of the key cached for the CPU, as a capture would leave
    it (its buffers hold another caller's inputs)."""
    occ = _occupant(seed)
    x = torch.zeros(N, dtype=torch.float64)
    entry = _EagerGraph(_acc, occ.inputs[:3] + (x,), STATIC, CARRIED)
    _graph._CACHES.setdefault(CPU, _graph.GraphCache(4)).put(occ.key, entry)
    return entry


def _call(occ, x):
    occ.write(3, x)
    (out,) = _graph._run(occ.core, occ.inputs, occ.static, False, occ)
    return out.clone()


def _eager(seed, chunks):
    """The same steps with the state carried in Python: (outputs, state,
    count) after each chunk."""
    scale, state, count, _ = _start(seed)
    seen = []
    for x in chunks:
        xp = torch.zeros(N, dtype=torch.float64)
        xp[:x.shape[-1]] = x
        state, count, out = _acc(scale, state, count, xp, *STATIC)
        seen.append((out, state, count))
    return seen


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_placed_occupant_copies_only_what_it_writes():
    """``place()`` copies the constant and the state into the buffers
    once (not the fresh input's placeholder); each call then copies its
    fresh input alone (a short one zero-padded), replays resident and
    returns the outputs that are not carried; the state lives in the
    buffers."""
    entry = _captured()
    occ = _occupant(1)
    placed = sum(t.numel() * t.element_size() for t in _start(1)[:3])
    occ.place()
    assert entry.holder() is occ and occ.inputs is entry.inputs
    assert _graph.COPY_IN_BYTES == placed
    chunks = _chunks(1)
    for k, (x, (out, state, count)) in enumerate(zip(chunks,
                                                     _eager(1, chunks))):
        before = _graph.COPY_IN_BYTES
        assert _same(_call(occ, x), out)
        assert _graph.COPY_IN_BYTES - before == x.numel() * 8
        assert _same(occ.inputs[1], state) and _same(occ.inputs[2], count)
        assert _graph.RESIDENT_REPLAYS == _graph.REPLAYS == k + 1
    assert torch.equal(entry.inputs[3][2:], torch.zeros(N - 2,
                                                        dtype=torch.float64))
    assert (_graph.SWITCHES, _graph.COPY_OUT_BYTES) == (0, 0)


def test_first_call_places_when_nothing_was_placed():
    """An occupant made before its key was captured places at its first
    write: that call is a replay, not a resident one; the next ones are."""
    occ = _occupant(2)
    entry = _captured()
    chunks = _chunks(2)
    for x, (out, state, _) in zip(chunks, _eager(2, chunks)):
        assert _same(_call(occ, x), out)
    assert _same(occ.inputs[1], state) and occ.inputs is entry.inputs
    assert _graph.REPLAYS == len(chunks)
    assert _graph.RESIDENT_REPLAYS == len(chunks) - 1


def test_two_occupants_in_turns_switch_and_save():
    """Two live occupants of one key, fed in turns: each answers as it
    does alone, each change of occupant is a switch that saves the
    other's carried state (cloned out) and places its own."""
    _captured()
    occs, chunks = [_occupant(3), _occupant(4)], [_chunks(3), _chunks(4)]
    want = [_eager(3, chunks[0]), _eager(4, chunks[1])]
    carried = N * 8 + 8
    for k in range(len(chunks[0])):
        for j in (0, 1):
            switches, out_bytes = _graph.SWITCHES, _graph.COPY_OUT_BYTES
            assert _same(_call(occs[j], chunks[j][k]), want[j][k][0])
            first = k == 0 and j == 0
            assert _graph.SWITCHES == switches + (not first)
            assert _graph.COPY_OUT_BYTES == out_bytes + (not first) * carried
    for occ, seen in zip(occs, want):
        assert _same(occ.inputs[1], seen[-1][1])
        assert _same(occ.inputs[2], seen[-1][2])
    assert _graph.RESIDENT_REPLAYS == 0


def test_a_collected_occupant_gives_up_its_claim():
    """An occupant that is garbage-collected leaves no claim: the next
    occupant places without a switch, and its first call is resident."""
    entry = _captured()
    gone = _occupant(5)
    gone.place()
    _call(gone, _chunks(5)[0])
    del gone
    gc.collect()
    assert entry.holder() is None
    occ = _occupant(6)
    occ.place()
    chunks = _chunks(6)
    for x, (out, _, _) in zip(chunks, _eager(6, chunks)):
        assert _same(_call(occ, x), out)
    assert _graph.SWITCHES == 0
    assert _graph.RESIDENT_REPLAYS == 1 + len(chunks)


def test_an_evicted_graph_stays_with_its_occupant():
    """Evicting the key from the cache while an occupant holds its graph
    takes neither its buffers nor its state: it keeps replaying that
    graph, exact."""
    entry = _captured()
    occ = _occupant(7)
    occ.place()
    chunks = _chunks(7)
    want = _eager(7, chunks)
    cache = _graph._CACHES[CPU]
    _call(occ, chunks[0])
    for j in range(cache.bound):
        cache.put(("other", j), object())
    assert cache.get(occ.key) is None
    for x, (out, state, _) in zip(chunks[1:], want[1:]):
        assert _same(_call(occ, x), out)
    assert occ.inputs is entry.inputs and _same(occ.inputs[1], state)
    assert _graph.RESIDENT_REPLAYS == len(chunks)


def test_cpu_occupant_runs_the_core_and_captures_nothing():
    """On the CPU ``compiled`` with an occupant runs the core on its own
    tensors, carries the state in them and keeps no graph."""
    occ = _occupant(8)
    chunks = _chunks(8)
    for x, (out, state, count) in zip(chunks, _eager(8, chunks)):
        occ.write(3, x)
        (got,) = _graph.compiled(occ.core, occ.inputs, occ.static,
                                 occupant=occ)
        assert _same(got, out)
        assert _same(occ.inputs[1], state) and _same(occ.inputs[2], count)
    assert not _graph._CACHES
    assert (_graph.CAPTURES, _graph.REPLAYS, _graph.RESIDENT_REPLAYS,
            _graph.COPY_IN_BYTES) == (0, 0, 0, 0)


@pytest.mark.parametrize("kw", [{}, {"num_peaks": 3}, {"backend": "stein"},
                                {"backend": "stein", "num_peaks": 3}],
                         ids=["cufft", "cufft_lattice", "stein",
                              "stein_lattice"])
@pytest.mark.parametrize("chunk_len", [512, None], ids=["pinned", "first"])
def test_cpu_streams_run_their_steps_and_capture_nothing(kw, chunk_len):
    """A CPU stream is its step's occupant from the pinned length on
    (built with it, or set by the first chunk), runs each step eagerly
    and keeps no graph and no pinned buffer."""
    rng = np.random.default_rng(11)
    needle = (rng.standard_normal(128)
              + 1j * rng.standard_normal(128)).astype(np.complex64)
    cap = (0.05 * rng.standard_normal(1300)).astype(np.complex64)
    cap[300:428] += needle
    freqs = np.arange(-600.0, 600.0, 100.0, dtype=np.float32)
    s = StreamingCAF(needle, freqs, 48_000.0, chunk_len=chunk_len,
                     device="cpu", **kw)
    assert (s._occupant is None) == (chunk_len is None)
    for a, b in ((0, 512), (512, 1300)):
        s.process(cap[a:b])
    assert s._occupant is not None and s._pinned is None
    assert s.best()[1] == 300
    assert not _graph._CACHES
    assert (_graph.CAPTURES, _graph.REPLAYS, _graph.RESIDENT_REPLAYS,
            _graph.SWITCHES) == (0, 0, 0, 0)
