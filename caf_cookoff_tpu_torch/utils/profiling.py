"""Observability: profiler traces and structured run reports (the JAX
package's ``utils/profiling.py``, with ``torch.profiler`` for the trace).

* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) of the host and, with a card, the device;
* :class:`RunReport` — the structured result record: peak estimate,
  peak-to-floor ratio (detection confidence), throughput, and the
  reference-format result lines.
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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace('/tmp/caf-trace'): run()`` -> ``log_dir/trace.json``.

    Degrades to a no-op (with a stderr note) where the profiler cannot
    start, as the JAX package's does."""
    import torch
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
