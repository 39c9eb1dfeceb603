"""The reference of ``entries/batched_stein_os_peak.py``: a long
capture searched over lags ``[0, lags)``, where the needle lies wholly
inside the capture, every bin."""

from __future__ import annotations

from benchmark.reference import caf


def lag_range(cell):
    """(first lag, end lag, FFT length) the entry ranks."""
    hay = int(cell.config["lags"]) + int(cell.config["needle_len"])
    return 0, int(cell.config["lags"]), 1 << (hay - 1).bit_length()


def run(cell, item, probes, precision="float64"):
    lo, hi, m = lag_range(cell)
    return caf.peaks(item["needles"], item["hays"], cell.freqs, cell.fs, m,
                     lo, hi, probes, precision, cell.device)
