"""Reading a ``torch.profiler`` trace of the window.

With ``--trace 1`` the window runs inside ``torch.profiler.profile``
over the CPU and the card, each step in a ``bench.<step>`` span (see
``window.Clock``).  From the trace this takes:

* the device's operations (kernels, memcpys, memsets, those replayed
  from a CUDA graph included) with their intervals; the spans' own
  device-side copies are not operations;
* the host's waits on the card: ``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize`` and ``cudaEventSynchronize`` calls;
* the spans, and the traced window: from the first search's start to
  the last search's end.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import stats
from benchmark.window import SPAN_PREFIX

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
TOP = 10


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""
    ops: List[Tuple[str, float, float]]             # (name, start, end)
    syncs: List[float]                               # start of each wait
    spans: Dict[str, List[Tuple[float, float]]]      # step -> intervals
    window: Tuple[float, float] = field(init=False)

    def __post_init__(self):
        searches = self.spans.get("search", [])
        if not searches:
            raise ValueError("the trace holds no search span")
        self.window = (searches[0][0], searches[-1][1])

    @property
    def searches(self) -> int:
        return len(self.spans["search"])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def inside(self):
        lo, hi = self.window
        return [(n, a, b) for n, a, b in self.ops if b > lo and a < hi]

    def busy(self):
        return stats.union(((a, b) for _, a, b in self.inside()),
                           *self.window)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernels(self):
        return [(n, a, b) for n, a, b in self.inside()
                if not n.startswith(("Memcpy", "Memset"))]

    def syncs_inside(self) -> int:
        lo, hi = self.window
        return sum(lo <= t <= hi for t in self.syncs)

    def device_ops(self) -> List[List]:
        """The operations that took most device time: [name, seconds]."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, a, b in self.inside():
            by_name[n] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, s] for n, s in top]

    def idle_gaps(self) -> List[List]:
        """The device's idle time in the window, by the innermost step
        the host was in: [step, seconds], most first."""
        lo, hi = self.window
        starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        by_step: Dict[str, float] = defaultdict(float)
        for a, b in stats.gaps(self.busy(), lo, hi):
            by_step[self._step_at((a + b) / 2, starts)] += b - a
        top = sorted(by_step.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, s] for n, s in top]

    def _step_at(self, t: float, starts) -> str:
        best: Optional[Tuple[float, str]] = None
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                length = ivs[i][1] - ivs[i][0]
                if best is None or length < best[0]:
                    best = (length, name)
        return best[1] if best else "between searches"


def _times_ns(e):
    """(start, end) nanoseconds of a raw profiler event."""
    if hasattr(e, "start_ns"):
        a = int(e.start_ns())
        return a, a + int(e.duration_ns())
    a = int(e.start_us()) * 1000
    return a, a + int(e.duration_us()) * 1000


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``, from its raw
    events (building the profiler's own event tree takes 50 times
    longer); times in seconds from the first event."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    base = min((_times_ns(e)[0] for e in raw), default=0)

    def secs(e):
        a, b = _times_ns(e)
        return (a - base) / 1e9, (b - base) / 1e9

    ops, syncs = [], []
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in raw:
        name, dev = e.name(), e.device_type()
        if name.startswith(SPAN_PREFIX):
            if dev == DeviceType.CPU:
                spans[name[len(SPAN_PREFIX):]].append(secs(e))
        elif dev == DeviceType.CUDA:
            ops.append((name, *secs(e)))
        elif name in SYNCS:
            syncs.append(secs(e)[0])
    for ivs in spans.values():
        ivs.sort()
    ops.sort(key=lambda op: op[1])
    return Trace(ops, syncs, dict(spans))
