"""Observability: profiler traces, the port's spans and structured run
reports (the JAX package's ``utils/profiling.py``, with
``torch.profiler`` for the trace).

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) of the host and, with a card, the device;
* :func:`span` — a named span of the port's host work, recorded only
  while a ``torch.profiler`` runs;
* :class:`RunReport` — the structured result record: peak estimate,
  peak-to-floor ratio (detection confidence), throughput, and the
  reference-format result lines.

**Spans.**  The port opens a span at each layer boundary of its public
calls: ``caf.call`` (one root a call of ``caf_peak`` /
``stein_caf_peak``, ``batched_stein_peak``, ``batched_stein_os_peak``),
``caf.prep`` (checks, grid upload, band plan, routing),
``caf.graph`` (``ops/_graph.compiled`` on a card) with
``caf.graph.copy_in`` / ``.launch`` / ``.copy_out`` for a replay and
``caf.graph.capture`` for a key's first call, and ``caf.read`` (the
packed answer to host values, the wait for the card included).  A
stream opens ``caf.stream.build`` (``caf.prep``,
``caf.stream.operator``), ``caf.stream.chunk`` (``caf.stream.upload``,
``caf.graph``, ``caf.read``) and ``caf.stream.best``.

Spans are on exactly while a profiler runs (``with trace(dir): ...``,
or the benchmark's ``--trace 1`` window): they are profiler events on
the profiler's clock, beside the device's operations.  Off, a ``with
span(...)`` still costs the flag's check and a no-op ``with``, ~0.6 µs
on an H100's host, so the paths that run on every call, replay or
chunk check :func:`recording` once and, when it is off, take a branch
that opens no span.  They are recorded as plain host events
(``RecordScope.FUNCTION``), which the profiler does not mirror onto the
device's timeline as it does ``record_function``'s annotations, so a
reader of the device's operations sees no span among them.  No span
opens inside a compiled call's core (that code is captured into a
graph), and none synchronises or launches device work.  Parentage is
nesting on the caller's thread: a search's spans are those inside its
interval, so one closed-loop caller needs no request id.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

# True while a torch.profiler runs, so that spans are recorded.
recording = torch._C._autograd._profiler_enabled
_host_span = torch._C._profiler._RecordFunctionFast
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("caf.prep"): ...`` — a profiler event named ``name``
    (every name starts with ``caf.``) while a profiler runs, else the
    one shared no-op context."""
    return _host_span(name) if recording() else _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace('/tmp/caf-trace'): run()`` -> ``log_dir/trace.json``.

    Degrades to a no-op (with a stderr note) where the profiler cannot
    start, as the JAX package's does.  The port's spans (:func:`span`)
    appear in it beside the kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
        started = True
    except RuntimeError as exc:
        print(f"profiler unavailable ({exc}); continuing untraced",
              file=sys.stderr)
        started = False
    try:
        yield
    finally:
        if started:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class RunReport:
    """Structured record of one CAF run."""

    freq_hz: float
    lag_samples: int
    peak_value: float
    sample_rate: float
    num_doppler_bins: int
    xcor_len: int
    elapsed_ms: Optional[float] = None
    peak_to_floor_db: Optional[float] = None
    backend: Optional[str] = None

    @property
    def lag_ms(self) -> float:
        return self.lag_samples / self.sample_rate * 1e3

    @property
    def surfaces_per_second(self) -> Optional[float]:
        return None if not self.elapsed_ms else 1e3 / self.elapsed_ms

    def result_lines(self) -> str:
        """The reference's two result lines, plus a bracketed line of
        what the reference does not report."""
        lines = [
            f"Frequency offset: {self.freq_hz:.3f} Hz",
            f"Time offset: {self.lag_samples} samples "
            f"({self.lag_ms:.4f} ms)",
        ]
        extra = []
        if self.peak_to_floor_db is not None:
            extra.append(f"peak/floor {self.peak_to_floor_db:.1f} dB")
        if self.elapsed_ms is not None:
            extra.append(f"{self.elapsed_ms:.3f} ms/surface")
            extra.append(f"{self.surfaces_per_second:.1f} surfaces/s")
        if self.backend:
            extra.append(self.backend)
        if extra:
            lines.append("[" + ", ".join(extra) + "]")
        return "\n".join(lines)

    def to_json(self) -> str:
        record = dataclasses.asdict(self)
        record["lag_ms"] = self.lag_ms
        record["surfaces_per_second"] = self.surfaces_per_second
        return json.dumps(record, sort_keys=True)


def peak_to_floor_db(surface: np.ndarray, peak_value: float,
                     guard_fraction: float = 0.01) -> float:
    """Detection confidence: the peak over the surface's median (dB).

    The median is taken on the host with ``np.median`` (the mean of the
    two middle values of an even count, where ``torch.median`` returns
    the lower one); ``guard_fraction`` is kept for the JAX signature and
    unused: the median already ignores the peak's cells."""
    del guard_fraction
    floor = float(np.median(np.asarray(surface)))
    if floor <= 0:
        return float("inf")
    return 10.0 * float(np.log10(peak_value / floor))


def report_run(surface: np.ndarray, freqs_hz: np.ndarray,
               sample_rate: float, *, elapsed_ms: Optional[float] = None,
               backend: Optional[str] = None) -> RunReport:
    """Build a :class:`RunReport` from a materialized surface (host)."""
    surface = np.asarray(surface)
    k, t = np.unravel_index(int(surface.argmax()), surface.shape)
    peak = float(surface[k, t])
    return RunReport(
        freq_hz=float(np.asarray(freqs_hz)[k]),
        lag_samples=int(t),
        peak_value=peak,
        sample_rate=float(sample_rate),
        num_doppler_bins=int(surface.shape[0]),
        xcor_len=int(surface.shape[1]),
        elapsed_ms=elapsed_ms,
        peak_to_floor_db=peak_to_floor_db(surface, peak),
        backend=backend,
    )


class Stopwatch:
    """Host wall-clock ms of a ``with`` block.  Work queued on a card is
    timed only as far as the block waits for it (a host read of a
    result does)."""

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        self.ms: Optional[float] = None
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3
