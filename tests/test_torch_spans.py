"""The port's spans (``utils/profiling.span``) on the CPU.

Under a CPU ``torch.profiler`` each public call records the ``caf.``
spans of its layers, nested on the caller's thread as the tree below
says.  The CPU runs no CUDA graph, so ``caf.graph`` and its children
appear only on a card (``tests/test_torch_cuda.py``).  With no profiler
running, ``span`` is one shared no-op and nothing is recorded.  The
file imports no JAX: :func:`span_tree` serves the card's tests too.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from caf_cookoff_tpu_torch import (StreamingCAF, batched_stein_os_peak,
                                   batched_stein_peak, caf_peak,
                                   stein_caf_peak)
from caf_cookoff_tpu_torch.utils import profiling

FS = 48_000.0
FREQS = np.arange(-100.0, 100.0, 12.5, dtype=np.float32)
CALL = ("caf.call", (("caf.prep", ()), ("caf.read", ())))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def span_tree(prof):
    """The ``caf.`` spans of a finished profile as ``(name, children)``
    tuples, nested by containment, roots in the order they began."""
    events = sorted(
        (e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("caf."))
    roots, stack = [], []
    for start, neg_end, name in events:
        node = (name, [])
        while stack and -neg_end > stack[-1][0]:
            stack.pop()
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((-neg_end, node))

    def frozen(node):
        return node[0], tuple(frozen(c) for c in node[1])
    return tuple(frozen(r) for r in roots)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, span_tree(prof)


def _pairs(p, n, hay_len, lag=40, seed=3):
    rng = np.random.default_rng(seed)
    ns = (rng.standard_normal((p, n))
          + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hs = (1e-2 * (rng.standard_normal((p, hay_len))
                  + 1j * rng.standard_normal((p, hay_len)))
          ).astype(np.complex64)
    if hay_len == n:
        hs += np.roll(ns, lag, axis=-1)
    else:
        hs[:, lag:lag + n] += ns
    return ns, hs


def test_stein_call_spans():
    ns, hs = _pairs(1, 256, 256)
    got, tree = _profiled(lambda: stein_caf_peak(ns[0], hs[0], FREQS, FS,
                                                 device="cpu"))
    assert tree == (CALL,)
    assert got == stein_caf_peak(ns[0], hs[0], FREQS, FS, device="cpu")


@pytest.mark.parametrize("backend", ["stein", "xla"])
def test_caf_peak_opens_one_root(backend):
    """``caf_peak``'s Stein route is ``stein_caf_peak``'s one root; its
    filterbank route opens its own."""
    ns, hs = _pairs(1, 256, 256)
    got, tree = _profiled(lambda: caf_peak(ns[0], hs[0], FREQS, FS,
                                           backend=backend, device="cpu"))
    assert tree == (CALL,)
    assert got == caf_peak(ns[0], hs[0], FREQS, FS, backend=backend,
                           device="cpu")


def test_batched_call_spans():
    ns, hs = _pairs(3, 256, 256)
    got, tree = _profiled(lambda: batched_stein_peak(ns, hs, FREQS, FS,
                                                     device="cpu"))
    assert tree == (CALL,)
    for a, b in zip(got, batched_stein_peak(ns, hs, FREQS, FS,
                                            device="cpu")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("freqs", [FREQS, np.arange(-3000.0, 3000.0, 25.0,
                                                    dtype=np.float32)],
                         ids=["windowed", "banded"])
def test_windowed_call_spans(freqs):
    ns, hs = _pairs(2, 256, 3000, lag=1500)
    got, tree = _profiled(lambda: batched_stein_os_peak(ns, hs, freqs, FS,
                                                        device="cpu"))
    assert tree == (CALL,)
    assert got[1].tolist() == [1500, 1500]


@pytest.mark.parametrize("num_peaks", [1, 2])
def test_stream_spans(num_peaks):
    """The build, each chunk (one oversized: its two steps share the
    chunk's span) and ``best()``."""
    ns, hs = _pairs(1, 256, 1400, lag=700)

    def run():
        s = StreamingCAF(ns[0], FREQS, FS, chunk_len=512, backend="stein",
                         num_peaks=num_peaks, device="cpu")
        local = [s.process(hs[0, :512]), s.process(hs[0, 512:1400])]
        return local, s.best()

    (local, best), tree = _profiled(run)
    step = (("caf.stream.upload", ()), ("caf.read", ()))
    read = ("caf.read", ())
    assert tree == (
        ("caf.stream.build", (("caf.prep", ()),
                              ("caf.stream.operator", ()))),
        ("caf.stream.chunk", step),
        ("caf.stream.chunk", step + step),
        ("caf.stream.best", (read,)))
    assert (local, best) == run()
    assert best[1] == 700


def test_no_span_without_a_profiler():
    """With no profiler running ``span`` is the one shared no-op, and a
    span opened then is not recorded by a profiler started inside it."""
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("caf.call") is profiling.span("caf.prep")
    assert profiling.span("caf.call") is profiling._NO_SPAN
    with profiling.span("caf.call"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert profiling.span("caf.prep") is not profiling._NO_SPAN
    assert span_tree(prof) == ()


def test_hot_paths_open_no_span_when_off(monkeypatch):
    """With no profiler running a public call opens one span site (the
    packed read) and a chunk none: each checks the profiler once and
    takes a branch without spans."""
    from caf_cookoff_tpu_torch.models import _stein_plan, streaming

    opened = []

    def counted(name):
        opened.append(name)
        return profiling._NO_SPAN
    for module in (_stein_plan, streaming):
        monkeypatch.setattr(module, "span", counted)
    ns, hs = _pairs(1, 256, 1024, lag=300)
    stein_caf_peak(ns[0], hs[0, :256], FREQS, FS, device="cpu")
    batched_stein_os_peak(ns, hs, FREQS, FS, device="cpu")
    assert opened == ["caf.read", "caf.read"]
    s = StreamingCAF(ns[0], FREQS, FS, chunk_len=512, backend="stein",
                     device="cpu")
    opened.clear()
    s.process(hs[0, :512])
    s.process(hs[0, 512:])
    assert opened == []


def test_spans_are_host_events_only():
    """A span is a plain host event, not a user annotation (which the
    profiler mirrors onto the device's timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("caf.call"):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "caf.call"]
    assert len(events) == 1
    assert events[0].device_type() == torch.autograd.DeviceType.CPU
    user = [e for e in prof.events() if e.name == "caf.call"]
    assert user and all(e.scope == 0 for e in user)   # RecordScope.FUNCTION


def test_chrome_trace_holds_the_call(tmp_path):
    ns, hs = _pairs(1, 256, 256)
    with profiling.trace(str(tmp_path)):
        stein_caf_peak(ns[0], hs[0], FREQS, FS, device="cpu")
    names = [e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]]
    assert names.count("caf.call") == 1
    assert {"caf.prep", "caf.read"} <= set(names)
