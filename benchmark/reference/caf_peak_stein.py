"""The reference of ``entries/caf_peak_stein.py``: one pair, the full
circular correlation of the zero-padded pair (``lags`` = 2N lags; lag
tau >= N stands for tau - 2N), every bin."""

from __future__ import annotations

from benchmark.reference import caf


def lag_range(cell):
    """(first lag, end lag, FFT length) the entry ranks."""
    m = int(cell.config["lags"])
    return 0, m, m


def run(cell, item, probes, precision="float64"):
    lo, hi, m = lag_range(cell)
    return caf.peaks(item["needles"], item["hays"], cell.freqs, cell.fs, m,
                     lo, hi, probes, precision, cell.device)
