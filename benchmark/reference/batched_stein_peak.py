"""The reference of ``entries/batched_stein_peak.py``: each pair of the
batch as ``caf_peak_stein``'s, the full circular correlation of the
zero-padded pair (``lags`` = 2N lags), every bin."""

from __future__ import annotations

from benchmark.reference import caf_peak_stein

lag_range = caf_peak_stein.lag_range
run = caf_peak_stein.run
