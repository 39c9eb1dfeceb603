"""The cook-off's input model: a swept band-limited chirp as needle, and
as haystack the needle delayed and frequency-shifted in faint noise.

A frozen copy of the signal model of ``caf_cookoff_tpu_torch/utils/
generate.py:37-109`` (itself the reference's ``utils/generate.py``),
with every draw taken from a ``numpy.random.Generator`` seeded by the
run's seed in place of the legacy global state:

* per seed, as the reference draws once per fixture set: the sweep's
  polynomial order, the lowpass's relative bandwidth and the sweep's
  range;
* per pair, in the reference's order: the lag, one unused uniform
  draw, the needle's two normal planes, the frequency offset and the
  haystack's noise.

The needle is complex white noise through a 127-tap ``firwin`` lowpass
(``filtfilt``; both copied here in numpy, equal to scipy's to rounding
and without its import, which takes seconds of every run's set-up),
Hann-tapered, cast to complex64 and swept along the
polynomial trajectory; the haystack is ``lag`` zeros, the needle and 96
zeros, shifted by the offset, plus sigma = 1e-5 complex noise, cast to
complex64 and cut to the needle's length (the reference's benchmark
reads ``count = len(needle)`` samples of it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def sweep_frequency(signal: np.ndarray, offset_hz, sample_rate: float
                    ) -> np.ndarray:
    """``generate.py:37-49``: a constant shift, or the reference's
    per-sample trajectory with its extra ``t/fs`` phase term."""
    t = np.arange(len(signal))
    if np.ndim(offset_hz) == 0:
        phase = 2 * np.pi * float(offset_hz) * t / sample_rate
    else:
        phase = (t / sample_rate
                 + np.cumsum(2 * np.pi * np.asarray(offset_hz)) / sample_rate)
    return np.exp(1j * phase) * signal


def firwin(taps: int, cutoff: float, fs: float) -> np.ndarray:
    """``scipy.signal.firwin(taps, cutoff, fs=fs)``: the windowed-sinc
    lowpass (Hamming window), scaled to unit gain at DC."""
    c = cutoff / (0.5 * fs)
    m = np.arange(taps) - 0.5 * (taps - 1)
    h = c * np.sinc(c * m) * np.hamming(taps)
    return h / np.sum(h)


def _fir_from_steady(b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``scipy.signal.lfilter(b, 1, x, zi=lfilter_zi(b, 1) * x[0])``: the
    FIR filter started as if ``x[0]`` had always been its input."""
    lead = np.full(len(b) - 1, x[0])
    return np.convolve(np.concatenate([lead, x]), b, mode="valid")


def filtfilt(b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``scipy.signal.filtfilt(b, 1, x)`` for an FIR ``b``: odd extension
    by ``3 * len(b)`` samples each side, forward and backward passes from
    the steady state, the extension cut off."""
    pad = 3 * len(b)
    ext = np.concatenate([2 * x[0] - x[pad:0:-1], x,
                          2 * x[-1] - x[-2:-(pad + 2):-1]])
    y = _fir_from_steady(b, ext)
    y = _fir_from_steady(b, y[::-1])[::-1]
    return y[pad:-pad]


def _chirp(rng: np.random.Generator, n: int, fs: float, order: int,
           rel_bw: float, sweep_hz: float, taps: int) -> np.ndarray:
    """``generate.py:52-71``, its draws from ``rng``."""
    lowpass = firwin(taps, 0.5 * rel_bw, fs)
    _ = rng.uniform(1e3, 10e3)          # the reference's unused draw
    noise = rng.normal(0, 1, n) + 1j * rng.normal(0, 1, n)
    shaped = np.hanning(n) * filtfilt(lowpass, noise)
    shaped = shaped.astype(np.complex64)
    trajectory = np.linspace(-1, 1, n) ** order * sweep_hz
    return sweep_frequency(shaped, trajectory, fs)


def make(config: Dict, seed: int, index: int, pairs: int) -> Dict:
    """Pool item ``index`` of ``seed``: ``needles`` and ``hays``
    ((pairs, N) complex64) and each pair's ``truth`` (offset Hz, lag)."""
    c = config["chirp"]
    n, fs = config["needle_len"], float(config["sample_rate_hz"])
    s = seed % 2 ** 64
    set_rng = np.random.default_rng([s, 0])
    order = int(set_rng.integers(*c["order"]))
    rel_bw = float(set_rng.uniform(*c["relative_bandwidth"]))
    sweep_hz = float(set_rng.uniform(*c["sweep_range_hz"]))
    rng = np.random.default_rng([s, 1 + index])
    needles = np.empty((pairs, n), np.complex64)
    hays = np.empty((pairs, config["haystack_len"]), np.complex64)
    truths = []
    for p in range(pairs):
        lag = int(rng.integers(*c["lag"]))
        needle = _chirp(rng, n, fs, order, rel_bw, sweep_hz,
                        c["taps"]).astype(np.complex64)
        offset = float(rng.uniform(*c["offset_hz"]))
        hay = np.concatenate([np.zeros(lag), needle,
                              np.zeros(c["trailing_zeros"])])
        hay = sweep_frequency(hay, offset, fs)
        sigma = c["noise_sigma"]
        hay = hay + (rng.normal(0, sigma, len(hay))
                     + 1j * rng.normal(0, sigma, len(hay)))
        needles[p] = needle
        hays[p] = hay.astype(np.complex64)[:hays.shape[1]]
        truths.append((offset, lag))
    return {"needles": needles, "hays": hays, "truths": truths}
