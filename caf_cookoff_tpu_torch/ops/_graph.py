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

**The resident path.**  A caller that keeps its inputs from one call to
the next (a stream's step: its constants and its carried state) passes
an :class:`Occupant`.  Its key's graph also writes the occupant's
*carried* outputs back into their inputs' buffers, and the occupant
keeps its inputs in those buffers: while it holds the graph, a replay
copies nothing in, and returns the outputs that leave the caller, not
copies of them.  The caller writes what changes (:meth:`Occupant.write`:
a chunk of samples, straight into its buffer).  One graph serves every
occupant of a key: the first to call after another saves that one's
carried state into tensors of its own and places its own inputs (a
switch), and an occupant that is garbage-collected loses its claim.  An
occupant keeps its graph alive, so an LRU eviction takes neither its
buffers nor its state.  One-shot calls bring new inputs every time and
take the copy-all replay above.

Each device keeps its graphs in a :class:`GraphCache` of ``MAX_GRAPHS``
entries, least recently used first out.  The kernels' launch counters
(``ops/fused_stein``, ``ops/pallas_caf``, ``ops/stein_rescore``) count a
launch where it runs: the first call's eager launches count, a
capture's do not, and each replay adds the launches its graph holds.
``CAPTURES`` and ``REPLAYS`` count graphs captured and replayed;
``RESIDENT_REPLAYS`` the replays of an occupant that held its graph
since its last call or :meth:`Occupant.place` (nothing resident copied
in); ``SWITCHES`` the occupant changes that saved a live occupant's
state.  ``COPY_IN_BYTES`` counts the bytes copied into the graphs'
input buffers (a copy-all replay's traced tensors, an occupant's
placements and writes) and ``COPY_OUT_BYTES`` the bytes cloned out (a
copy-all replay's outputs, a switch's saved state).  :func:`entries`
reports each graph's capture time and pool memory, :func:`copy_bytes`
the bytes a copy-all replay of each copies (reckoned once, at its
capture).

On a card a call opens the span ``caf.graph`` (``utils/profiling.span``)
and, inside it, ``caf.graph.copy_in``, ``caf.graph.launch`` and
``caf.graph.copy_out`` for a replay or ``caf.graph.capture`` for a
key's first call.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import torch

from caf_cookoff_tpu_torch.ops import fused_stein, pallas_caf, stein_rescore
from caf_cookoff_tpu_torch.utils.profiling import recording, span

# Graphs a device keeps (each holds its pool's memory): the benchmark's
# cells alone make ~16 keys, the streams' and windowed engines' among
# them, and a run that cycles through more keys than this captures anew
# at every call.
MAX_GRAPHS = 32
CAPTURES = 0
REPLAYS = 0
RESIDENT_REPLAYS = 0
SWITCHES = 0
COPY_IN_BYTES = 0
COPY_OUT_BYTES = 0

# The kernel launch counters a replay adds to: (module, counter name).
_COUNTERS = ((fused_stein, "LAUNCHES"), (fused_stein, "SPLIT_LAUNCHES"),
             (fused_stein, "PIPELINED_LAUNCHES"),
             (pallas_caf, "PEAK_LAUNCHES"), (pallas_caf, "SURFACE_LAUNCHES"),
             (stein_rescore, "RESCORE_LAUNCHES"))
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


class _Graph:
    """A key's captured graph, the buffers it reads and writes, and the
    occupant whose inputs the buffers hold."""

    def __init__(self, graph, inputs, outputs, single: bool, launches,
                 done, capture_ms: float, pool_bytes: int):
        self.graph = graph
        self.inputs: Tuple[torch.Tensor, ...] = inputs    # traced buffers
        self.outputs: Tuple[torch.Tensor, ...] = outputs  # in its pool
        self.single = single              # core returned one tensor
        self.launches = launches          # (module, counter, n) a replay
        self.done = done                  # the last replay's copy-out
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.copy_in = _nbytes(inputs)    # bytes a copy-all replay copies
        self.copy_out = _nbytes(outputs)  # in and clones out
        self.holder = None                # weakref to an Occupant

    def fence(self) -> None:
        """Rewrite the buffers only after the last replay's outputs were
        read out, whatever stream that replay ran on."""
        torch.cuda.current_stream(self.inputs[0].device).wait_event(
            self.done)

    def close(self) -> None:
        self.done.record(torch.cuda.current_stream(self.inputs[0].device))


class Occupant:
    """A caller that keeps its traced inputs in its key's graph buffers
    from one call to the next: the resident path (module docstring).

    ``carried`` pairs (output index, input index): the graph writes each
    such output into that input's buffer, and :func:`compiled` returns
    only the other outputs, as a tuple — on a card the graph's own
    tensors, valid until the key's next replay.  Inputs in ``fresh``
    change at every call and are written before it (:meth:`write`);
    every other input keeps the tensor given here unless written.
    :attr:`inputs` are the graph's buffers while this occupant holds
    them, else its own tensors (on the CPU, always)."""

    def __init__(self, core: Callable, traced, static=(), carried=(),
                 fresh=()):
        self.core, self.static = core, tuple(static)
        self.carried = tuple(carried)
        self._carried_in = frozenset(i for _, i in self.carried)
        self._carried_out = frozenset(o for o, _ in self.carried)
        self._fresh = frozenset(fresh)
        self._own = list(traced)
        self._device = self._own[0].device
        self.key = static_key(core, self._own, self.static) + (self.carried,)
        for i in self._fresh:    # only its shape counts until written
            self._own[i] = None
        self._entry = None       # the graph it holds or held: kept alive
        self._moved = False      # a placement copied inputs since a call

    @property
    def inputs(self) -> Tuple[torch.Tensor, ...]:
        return self._entry.inputs if self._holds() else tuple(self._own)

    def place(self) -> None:
        """Place the inputs in the key's buffers now, where the key has a
        graph (a build's set-up), so the next call copies nothing
        resident."""
        with _LOCK:
            entry = self._find(_CACHES.get(self._device))
            if entry is not None:
                self._claim(entry)
        self._moved = False

    def write(self, i: int, src: torch.Tensor) -> None:
        """Input ``i`` becomes ``src``, zero-padded along its last axis to
        the input's length; a host ``src`` (pinned, for the copy to
        overlap) goes up without waiting for the card.  Held: copied
        straight into the buffer."""
        with _LOCK:
            entry = self._find(_CACHES.get(self._device))
            if entry is None:
                shape, dtype = self.key[2][i]
                self._own[i] = _fit(src.to(self._device, non_blocking=True),
                                    shape, dtype)
                return
            self._claim(entry)
            entry.fence()
            _put(entry.inputs[i], src)
            if i not in self._carried_in:
                # Kept, so that a later placement writes it again.
                self._own[i] = src

    def _holds(self) -> bool:
        entry = self._entry
        return (entry is not None and entry.holder is not None
                and entry.holder() is self)

    def _find(self, cache):
        """The graph this occupant holds or held, else its key's, if
        captured."""
        if self._entry is not None or cache is None:
            return self._entry
        return cache.get(self.key)

    def _claim(self, entry: _Graph) -> None:
        """Hold ``entry``: save a live holder's carried state into its own
        tensors, then place this occupant's inputs."""
        global SWITCHES
        if self._holds():
            return
        other = entry.holder() if entry.holder is not None else None
        entry.fence()
        if other is not None:
            other._save(entry)
            SWITCHES += 1
        for buf, t in zip(entry.inputs, self._own):
            if t is not None:
                _put(buf, t)
                self._moved = True
        self._hold(entry)

    def _hold(self, entry: _Graph) -> None:
        entry.holder = weakref.ref(self)
        self._entry = entry
        for i in self._carried_in:
            self._own[i] = None

    def _save(self, entry: _Graph) -> None:
        global COPY_OUT_BYTES
        for i in self._carried_in:
            self._own[i] = entry.inputs[i].clone()
            COPY_OUT_BYTES += _nbytes((self._own[i],))

    def _returned(self, outputs) -> Tuple[torch.Tensor, ...]:
        """The call is over: its fresh inputs are spent; the outputs that
        leave the caller."""
        for i in self._fresh:
            self._own[i] = None
        self._moved = False
        return tuple(t for j, t in enumerate(outputs)
                     if j not in self._carried_out)

    def _keep(self, outputs) -> Tuple[torch.Tensor, ...]:
        """An eager call (the CPU): the carried outputs become the
        inputs."""
        for o, i in self.carried:
            self._own[i] = outputs[o]
        return self._returned(outputs)


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` into ``dst``, the rest of ``dst``'s last axis zeroed where
    ``src`` is shorter: counted in ``COPY_IN_BYTES``."""
    global COPY_IN_BYTES
    if src.shape != dst.shape:
        n = src.shape[-1]
        dst[..., n:].zero_()
        dst = dst[..., :n]
    dst.copy_(src, non_blocking=True)
    COPY_IN_BYTES += _nbytes((dst,))


def _fit(src: torch.Tensor, shape, dtype) -> torch.Tensor:
    src = src.to(dtype)
    if tuple(src.shape) == shape:
        return src
    out = src.new_zeros(shape)
    out[..., :src.shape[-1]] = src
    return out


def static_key(core: Callable, traced, static) -> tuple:
    """The compiled call's key: ``core``, the device, each traced
    tensor's shape and dtype, and the static arguments — never the
    traced tensors' values."""
    return (core, traced[0].device,
            tuple((tuple(t.shape), t.dtype) for t in traced), tuple(static))


def compiled(core: Callable, traced, static=(), occupant=None):
    """``core(*traced, *static)``, replayed from its key's CUDA graph on
    a card (captured at the key's first call), eager on the CPU.  With an
    ``occupant`` (whose ``core``, ``inputs`` and ``static`` these are),
    the resident path: its outputs that are not carried, as a tuple."""
    traced = tuple(traced)
    dev = traced[0].device
    if dev.type != "cuda":
        out = core(*traced, *static)
        return out if occupant is None else occupant._keep(_as_tuple(out))
    if not recording():
        return _run(core, traced, static, False, occupant)
    with span("caf.graph"):
        return _run(core, traced, static, True, occupant)


def _run(core, traced, static, spans: bool, occupant=None):
    with _LOCK:
        cache = _CACHES.setdefault(traced[0].device, GraphCache(MAX_GRAPHS))
        if occupant is None:
            key = static_key(core, traced, static)
            entry = cache.get(key)
        else:
            key = occupant.key
            # A use for the LRU, whichever graph the occupant holds.
            entry = cache.get(key)
            entry = occupant._entry or entry
        if entry is None:
            with span("caf.graph.capture"):
                entry, out = _capture(core, traced, static,
                                      () if occupant is None
                                      else occupant.carried)
            # The capture synchronised the card, so no replay of a graph
            # this drops is still running.
            cache.put(key, entry)
            if occupant is None:
                return out
            occupant._hold(entry)
            return occupant._returned(_as_tuple(out))
        return _replay(entry, traced, spans, occupant)


def _kept(device):
    """The graphs kept for ``device`` (default: the current card), least
    recently used first."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        cache = _CACHES.get(dev)
        return [] if cache is None else cache.items()


def entries(device=None):
    """``(key, capture ms, pool bytes)`` of each graph kept for
    ``device`` (default: the current card), least recently used
    first."""
    return [(k, e.capture_ms, e.pool_bytes) for k, e in _kept(device)]


def copy_bytes(device=None):
    """``(key, bytes copied in, bytes cloned out)`` a copy-all replay of
    each graph kept for ``device`` moves, as :func:`entries` orders
    them."""
    return [(k, e.copy_in, e.copy_out) for k, e in _kept(device)]


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _add_counts(launches) -> None:
    for mod, name, n in launches:
        setattr(mod, name, getattr(mod, name) + n)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def _capture(core, traced, static, carried=()):
    """The first call of a key: the eager answer and the captured graph.
    Each ``carried`` (output, input) pair's output is written into that
    input's buffer, eagerly and in the graph."""
    global CAPTURES
    dev = traced[0].device
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    inputs = tuple(t.detach().clone(memory_format=torch.contiguous_format)
                   for t in traced)

    def run():
        out = core(*inputs, *static)
        for o, i in carried:
            inputs[i].copy_(_as_tuple(out)[o])
        return out

    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = run()
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
            outputs = _as_tuple(run())
    except Exception as exc:
        raise RuntimeError(f"CUDA graph capture of {core.__qualname__} "
                           f"failed: {exc}") from exc
    finally:
        # A capture launches nothing: take back what its launches counted.
        after = _counts()
        _add_counts([(mod, name, b - a) for (mod, name), b, a
                     in zip(_COUNTERS, before, after)])
    capture_ms = (time.perf_counter() - t0) * 1e3
    launches = tuple((mod, name, a - b) for (mod, name), b, a
                     in zip(_COUNTERS, before, after) if a != b)
    entry = _Graph(graph, inputs, outputs, isinstance(out, torch.Tensor),
                   launches, torch.cuda.Event(), capture_ms,
                   torch.cuda.memory_reserved(dev) - reserved)
    cur.wait_stream(side)
    for t in _as_tuple(out):
        t.record_stream(cur)
    CAPTURES += 1
    return entry, out


def _replay(entry: _Graph, traced, spans: bool, occupant=None):
    """Copy the traced tensors in (an occupant: claim the buffers),
    replay, copy the outputs out: each step in its span when
    ``spans``."""
    if not spans:
        _copy_in(entry, traced, occupant)
        entry.graph.replay()
        return _copy_out(entry, occupant)
    with span("caf.graph.copy_in"):
        _copy_in(entry, traced, occupant)
    with span("caf.graph.launch"):
        entry.graph.replay()
    with span("caf.graph.copy_out"):
        return _copy_out(entry, occupant)


def _copy_in(entry: _Graph, traced, occupant) -> None:
    if occupant is not None:
        occupant._claim(entry)
        return
    entry.fence()
    for buf, t in zip(entry.inputs, traced):
        buf.copy_(t)


def _copy_out(entry: _Graph, occupant):
    global REPLAYS, RESIDENT_REPLAYS, COPY_IN_BYTES, COPY_OUT_BYTES
    REPLAYS += 1
    if occupant is not None:
        entry.close()
        _add_counts(entry.launches)
        RESIDENT_REPLAYS += not occupant._moved
        return occupant._returned(entry.outputs)
    outputs = tuple(t.clone() for t in entry.outputs)
    entry.close()
    _add_counts(entry.launches)
    COPY_IN_BYTES += entry.copy_in
    COPY_OUT_BYTES += entry.copy_out
    return outputs[0] if entry.single else outputs
