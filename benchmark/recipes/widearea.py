"""The wide-area search's input model: one noise needle and, in a long
capture of unit complex noise, the needle three times as strong,
delayed and frequency-shifted onto a grid cell.

A frozen copy of config 3's recipe, ``caf_cookoff_tpu_torch/utils/
bench_configs.py:142-156`` (the JAX package's root ``bench_configs.py:
211-239``), with the emitter's bin and lag drawn from the run's seed
inside the recipe's ranges (any bin of the grid, any lag the capture
holds whole) in place of the fixed (bin 1234, lag 30000), and each pool
item's needle and noise drawn anew.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make(config: Dict, seed: int, index: int, pairs: int) -> Dict:
    """Pool item ``index`` of ``seed``: ``needles`` (pairs, N) and
    ``hays`` (pairs, lags + N) complex64, and each pair's ``truth``
    (bin, lag)."""
    n, lags = config["needle_len"], config["lags"]
    fs = float(config["sample_rate_hz"])
    freqs = (config["freq_start_hz"] + config["freq_step_hz"]
             * np.arange(config["bins"])).astype(np.float32)
    rng = np.random.default_rng([seed % 2 ** 64, 1 + index])
    t = np.arange(n)
    needles = np.empty((pairs, n), np.complex64)
    hays = np.empty((pairs, lags + n), np.complex64)
    truths = []
    for p in range(pairs):
        needle = (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
        hay = (rng.standard_normal(lags + n)
               + 1j * rng.standard_normal(lags + n)).astype(np.complex64)
        k = int(rng.integers(0, config["bins"]))
        lag = int(rng.integers(0, lags))
        hay[lag:lag + n] += config["emitter_amplitude"] * (needle * np.exp(
            2j * np.pi * float(freqs[k]) * t / fs)).astype(np.complex64)
        needles[p], hays[p] = needle, hay
        truths.append((float(freqs[k]), lag))
    return {"needles": needles, "hays": hays, "truths": truths}
