"""Deterministic test-fixture synthesis.

Writes the same ten (needle, haystack) chirp pairs as the reference's
``utils/generate.py``, byte for byte: the golden tests assert exact
grid-snapped peaks against ground truth encoded in the file names.  That
requires replaying the reference's legacy-numpy RNG draw order (seed 0)
and its exact op/dtype sequence, including one *unused* uniform draw per
chirp that must still consume RNG state.

Signal model:
  * needle: complex white noise lowpassed by a 127-tap firwin kernel via
    filtfilt, Hann-tapered, cast to c64, then swept by a polynomial
    frequency trajectory (the "chirp");
  * haystack: the needle delayed by ``lag`` samples, 96 trailing zeros,
    a constant frequency offset, plus sigma=1e-5 complex white noise.

Ground truth lives in the haystack filename:
``chirp_{i}_T{+lag}samp_F{+off:.2f}Hz.c64``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import scipy.signal

from caf_cookoff_tpu_torch.utils.io import PathLike

CHIRP_LENGTH = 4096
SAMPLE_RATE = 48e3
TRAILING_ZEROS = 96
NUM_PAIRS = 10


def sweep_frequency(signal: np.ndarray, offset_hz, sample_rate: float) -> np.ndarray:
    """Frequency-translate ``signal`` by a constant or per-sample offset.

    The time-varying branch phases the signal by
    ``t/fs + cumsum(2*pi*f)/fs`` — an extra linear term relative to the
    textbook form, but the fixtures were generated with it.
    """
    t = np.arange(len(signal))
    if np.ndim(offset_hz) == 0:
        phase = 2 * np.pi * float(offset_hz) * t / sample_rate
    else:
        phase = t / sample_rate + np.cumsum(2 * np.pi * np.asarray(offset_hz)) / sample_rate
    return np.exp(1j * phase) * signal


def synthesize_chirp(sample_rate: float,
                     chirp_length: int = CHIRP_LENGTH,
                     chirp_order: int = 2,
                     relative_bandwidth: float = 1e-2,
                     sweep_range_hz: float = 10e3,
                     taper=np.hanning) -> np.ndarray:
    """One band-limited swept-noise chirp.

    Consumes RNG draws in the reference's order: one unused uniform,
    then two standard-normal vectors.
    """
    lowpass = scipy.signal.firwin(127, cutoff=0.5 * relative_bandwidth, fs=sample_rate)
    _ = np.random.uniform(1e3, 10e3)  # dead draw kept for RNG-state parity
    noise = np.random.normal(0, 1, chirp_length) + 1j * np.random.normal(0, 1, chirp_length)
    shaped = scipy.signal.filtfilt(lowpass, 1, noise)
    if taper is not None:
        shaped = taper(chirp_length) * shaped
    shaped = shaped.astype(np.complex64)
    trajectory = np.linspace(-1, 1, chirp_length) ** chirp_order * sweep_range_hz
    return sweep_frequency(shaped, trajectory, sample_rate)


def synthesize_fixtures(data_dir: PathLike,
                        count: int = NUM_PAIRS,
                        seed: int = 0,
                        sample_rate: float = SAMPLE_RATE) -> List[Tuple[str, str]]:
    """Write ``count`` (needle, haystack) fixture pairs; return their paths."""
    data_dir = os.fspath(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    np.random.seed(seed)

    order = np.random.randint(2, 5)
    rel_bw = np.random.uniform(1e-3, 5e-2)
    sweep_hz = np.random.uniform(1e3, 10e3)

    pairs = []
    for idx in range(count):
        search_band_hz = 1e2
        lag = np.random.randint(7, 256)
        needle = synthesize_chirp(
            sample_rate=sample_rate, chirp_length=CHIRP_LENGTH,
            chirp_order=order, relative_bandwidth=rel_bw,
            sweep_range_hz=sweep_hz).astype(np.complex64)
        needle_path = os.path.join(data_dir, f"chirp_{idx:d}_raw.c64")
        needle.tofile(needle_path)

        offset_hz = np.random.uniform(-search_band_hz, search_band_hz)
        haystack = np.concatenate(
            [np.zeros(lag), needle, np.zeros(TRAILING_ZEROS)])
        haystack = sweep_frequency(haystack, offset_hz, sample_rate)
        haystack += (np.random.normal(0, 1e-5, len(haystack))
                     + 1j * np.random.normal(0, 1e-5, len(haystack)))
        haystack = haystack.astype(np.complex64)
        haystack_path = os.path.join(
            data_dir, f"chirp_{idx:d}_T{lag:+d}samp_F{offset_hz:+.2f}Hz.c64")
        haystack.tofile(haystack_path)
        pairs.append((needle_path, haystack_path))
    return pairs


def ensure_fixtures(data_dir: PathLike, count: int = NUM_PAIRS) -> List[Tuple[str, str]]:
    """Generate fixtures only if the needles are not already present."""
    data_dir = os.fspath(data_dir)
    existing = [os.path.join(data_dir, f"chirp_{i}_raw.c64") for i in range(count)]
    if all(os.path.exists(p) for p in existing):
        pairs = []
        names = sorted(os.listdir(data_dir))
        for i in range(count):
            hay = [n for n in names if n.startswith(f"chirp_{i}_T")]
            if not hay:
                break
            pairs.append((existing[i], os.path.join(data_dir, hay[0])))
        if len(pairs) == count:
            return pairs
    return synthesize_fixtures(data_dir, count=count)
