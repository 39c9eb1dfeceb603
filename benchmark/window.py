"""The measured window: a closed loop of searches over the cell's pool,
timed on the device's clock.

A caller waits for each answer before it sends the next search, as a
geolocation pipeline does.  Search ``i`` runs on pool item ``i mod
pool``, so no answer can be reused.  The clock records a CUDA event at
the end of each step of a search (a stream's build, each chunk, its
``best()``) and at the end of the search: a step's time is the time
between its event and the one before.  After each mark the clock reads
the times of the events the card has already passed (a query, no wait)
and reuses them, so a few events created before the window serve all
of it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, Tuple

import torch

SPAN_PREFIX = "bench."


class Clock:
    """Marks on the device's timeline (``time.perf_counter`` where the
    device is the CPU, which only the CPU tests use).  With ``trace``
    each step is a ``torch.profiler`` span named ``bench.<step>`` in
    place of a mark: a traced run reports no time of its own, and under
    the profiler each event recorded costs host time that the trace
    would count as the device's idle time."""

    def __init__(self, device: str, trace: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.trace = trace
        self._done: List[Tuple[str, float]] = []
        self._pending = collections.deque()
        self._spare: List[object] = []

    def reserve(self, count: int) -> None:
        """Create ``count`` events and record each once, so that the
        window creates none."""
        if not self.cuda or self.trace:
            return
        for _ in range(count):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spare.append(ev)
        torch.cuda.synchronize()

    def mark(self, label: str) -> None:
        if self.cuda:
            ev = (self._spare.pop() if self._spare
                  else torch.cuda.Event(enable_timing=True))
            ev.record()
        else:
            ev = time.perf_counter()
        self._pending.append((label, ev))
        self._read()

    def _read(self) -> None:
        """Turn each pair of marks the card has passed into a step's ms,
        and give the earlier event back for reuse."""
        while len(self._pending) >= 2:
            (_, a), (label, b) = self._pending[0], self._pending[1]
            if self.cuda and not b.query():
                return
            self._done.append((label, a.elapsed_time(b) if self.cuda
                               else (b - a) * 1e3))
            self._pending.popleft()
            if self.cuda:
                self._spare.append(a)

    @contextlib.contextmanager
    def step(self, label: str):
        if self.trace:
            with torch.profiler.record_function(SPAN_PREFIX + label):
                yield
        else:
            yield
            self.mark(label)

    def durations_ms(self) -> List[Tuple[str, float]]:
        """(label, ms) of every mark after the first: the time since the
        mark before it."""
        if self.cuda:
            torch.cuda.synchronize()
        self._read()
        return list(self._done)


def search_ms(durations) -> List[float]:
    """Each search's ms: from the end of the search before, through all
    its steps."""
    out, acc = [], 0.0
    for label, ms in durations:
        acc += ms
        if label == "search":
            out.append(acc)
            acc = 0.0
    return out


def step_ms(durations, label: str) -> List[float]:
    """Each ms of the steps named ``label``."""
    return [ms for lab, ms in durations if lab == label]


def run(entry, cell, items, seconds: float, clock: Clock):
    """Searches back to back for ``seconds`` by the host's clock:
    ``(answers [(pool index, answer)], window seconds)``.  The window
    closes when the search that passes ``seconds`` has its answer."""
    answers = []
    if not clock.trace:
        clock.mark("start")
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % len(items)
        with clock.step("search"):
            ans = entry.search(cell, items[k], clock)
        answers.append((k, ans))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return answers, time.perf_counter() - t0
