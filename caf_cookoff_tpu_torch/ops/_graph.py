"""Compiled calls: one CUDA graph per static key, the port's counterpart
of ``jax.jit`` on the Stein main path, the streams' steps and the
windowed engines.

``compiled(core, traced, static)`` returns ``core(*traced, *static)``,
a tensor or a tuple of tensors.  CPU tensors call ``core`` directly.  On
a card the call is keyed as ``jax.jit`` keys a compiled program: the
device, each traced tensor's shape and dtype, and the static arguments
(``static_argnames``'s counterpart: lengths, flags, the sample rate).

* The first call of a key copies the traced tensors into static
  buffers, runs ``core`` on them eagerly on a side stream — its
  host-side checks raise their typed errors there, before anything is
  captured, and it creates the cuFFT plans and sets the kernels' launch
  attributes — and returns that answer.  It then captures ``core`` on
  the same buffers into a ``torch.cuda.CUDAGraph`` with its own memory
  pool.  A failed capture ends the capture, caches nothing and raises.
* Every later call of the key copies its traced tensors into the
  buffers, replays the graph and returns copies of its outputs: a new
  grid of the same shape gives the eager answer for that grid, and two
  calls never share an output.

Each device keeps its graphs in a :class:`GraphCache` of ``MAX_GRAPHS``
entries, least recently used first out.  The kernels' launch counters
(``ops/fused_stein``, ``ops/pallas_caf``) count a launch where it runs:
the first call's eager launches count, a capture's do not, and each
replay adds the launches its graph holds.  ``CAPTURES`` and ``REPLAYS``
count graphs captured and replayed; :func:`entries` reports each
graph's capture time and pool memory.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Tuple

import torch

# Graphs a device keeps (each holds its pool's memory): the benchmark's
# cells alone make ~16 keys, the streams' and windowed engines' among
# them, and a run that cycles through more keys than this captures anew
# at every call.
MAX_GRAPHS = 32
CAPTURES = 0
REPLAYS = 0

# The kernel launch counters a replay adds to: module -> counter names.
_COUNTERS = {
    "caf_cookoff_tpu_torch.ops.fused_stein": ("LAUNCHES", "SPLIT_LAUNCHES"),
    "caf_cookoff_tpu_torch.ops.pallas_caf": ("PEAK_LAUNCHES",
                                             "SURFACE_LAUNCHES"),
}
_LOCK = threading.Lock()
_CACHES: Dict[torch.device, "GraphCache"] = {}
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


class GraphCache:
    """A bounded LRU map: :meth:`put` past ``bound`` entries drops the
    least recently used (a :meth:`get` hit counts as a use)."""

    def __init__(self, bound: int):
        self.bound = bound
        self._items: "OrderedDict" = OrderedDict()

    def get(self, key):
        item = self._items.get(key)
        if item is not None:
            self._items.move_to_end(key)
        return item

    def put(self, key, item) -> None:
        self._items[key] = item
        self._items.move_to_end(key)
        while len(self._items) > self.bound:
            self._items.popitem(last=False)

    def items(self):
        return list(self._items.items())

    def __len__(self) -> int:
        return len(self._items)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]     # the traced arguments' buffers
    outputs: Tuple[torch.Tensor, ...]    # in the graph's pool
    single: bool                         # core returned one tensor
    launches: Dict[Tuple[str, str], int]  # kernel launches a replay runs
    done: "torch.cuda.Event"             # the last replay's copy-out
    capture_ms: float
    pool_bytes: int


def static_key(core: Callable, traced, static) -> tuple:
    """The compiled call's key: ``core``, the device, each traced
    tensor's shape and dtype, and the static arguments — never the
    traced tensors' values."""
    return (core, traced[0].device,
            tuple((tuple(t.shape), t.dtype) for t in traced), tuple(static))


def compiled(core: Callable, traced, static=()):
    """``core(*traced, *static)``, replayed from its key's CUDA graph on
    a card (captured at the key's first call), eager on the CPU."""
    traced = tuple(traced)
    dev = traced[0].device
    if dev.type != "cuda":
        return core(*traced, *static)
    key = static_key(core, traced, static)
    with _LOCK:
        cache = _CACHES.setdefault(dev, GraphCache(MAX_GRAPHS))
        entry = cache.get(key)
        if entry is None:
            entry, out = _capture(core, traced, static)
            # The capture synchronised the card, so no replay of a graph
            # this drops is still running.
            cache.put(key, entry)
            return out
        return _replay(entry, traced)


def entries(device=None):
    """``(key, capture ms, pool bytes)`` of each graph kept for
    ``device`` (default: the current card), least recently used
    first."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        cache = _CACHES.get(dev)
        if cache is None:
            return []
        return [(k, e.capture_ms, e.pool_bytes) for k, e in cache.items()]


def _counts() -> Dict[Tuple[str, str], int]:
    return {(m, name): getattr(importlib.import_module(m), name)
            for m, names in _COUNTERS.items() for name in names}


def _add_counts(counts) -> None:
    for (m, name), n in counts.items():
        mod = importlib.import_module(m)
        setattr(mod, name, getattr(mod, name) + n)


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def _capture(core, traced, static):
    """The first call of a key: the eager answer and the captured
    graph."""
    global CAPTURES
    dev = traced[0].device
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    inputs = tuple(t.detach().clone(memory_format=torch.contiguous_format)
                   for t in traced)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = core(*inputs, *static)
    before = _counts()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        # The outer stream context restores the caller's stream even when
        # ending a failed capture raises inside the graph context.
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            outputs = _as_tuple(core(*inputs, *static))
    except Exception as exc:
        raise RuntimeError(f"CUDA graph capture of {core.__qualname__} "
                           f"failed: {exc}") from exc
    finally:
        after = _counts()
        _add_counts({k: before[k] - after[k] for k in before})
    capture_ms = (time.perf_counter() - t0) * 1e3
    entry = _Graph(graph, inputs, outputs, isinstance(out, torch.Tensor),
                   {k: after[k] - before[k] for k in before
                    if after[k] != before[k]},
                   torch.cuda.Event(), capture_ms,
                   torch.cuda.memory_reserved(dev) - reserved)
    cur.wait_stream(side)
    for t in _as_tuple(out):
        t.record_stream(cur)
    CAPTURES += 1
    return entry, out


def _replay(entry: _Graph, traced):
    global REPLAYS
    cur = torch.cuda.current_stream(traced[0].device)
    # The buffers are rewritten only after the last replay's outputs
    # were copied out, whatever stream that replay ran on.
    cur.wait_event(entry.done)
    for buf, t in zip(entry.inputs, traced):
        buf.copy_(t)
    entry.graph.replay()
    outputs = tuple(t.clone() for t in entry.outputs)
    entry.done.record(cur)
    _add_counts(entry.launches)
    REPLAYS += 1
    return outputs[0] if entry.single else outputs
