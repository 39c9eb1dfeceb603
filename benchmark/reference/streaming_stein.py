"""The reference of ``entries/streaming_stein.py``: a capture of L
samples fed from its first sample ranks every lag from -(N-1), where
the needle's last sample meets the capture's first, to L - N, where
the needle meets the capture's last N samples (the capture counts as
zeros before its start); every bin.  Each chunk of ``chunk_len``
samples (the last one shorter) ranks the lags whose needle ends inside
it: a chunk's own peak is the argmax over those lags."""

from __future__ import annotations

from benchmark.reference import caf


def lag_range(cell):
    """(first lag, end lag, FFT length) the entry ranks."""
    n = int(cell.config["needle_len"])
    cap = int(cell.config["lags"]) + n
    return -(n - 1), cap - n + 1, 1 << (cap + n - 2).bit_length()


def chunk_spans(cell):
    """[(first lag, end lag)] each chunk ranks, in the order fed."""
    n = int(cell.config["needle_len"])
    cap = int(cell.config["lags"]) + n
    step = int(cell.workload["chunk_len"])
    return [(s - n + 1, min(s + step, cap) - n + 1)
            for s in range(0, cap, step)]


def run(cell, item, probes, precision="float64"):
    lo, hi, m = lag_range(cell)
    return caf.peaks(item["needles"], item["hays"], cell.freqs, cell.fs, m,
                     lo, hi, probes, precision, cell.device,
                     chunk_spans(cell))
