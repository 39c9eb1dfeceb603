"""Configuration dataclasses for the CAF engine (PyTorch port).

Same grids, backend names and validation as ``caf_cookoff_tpu.config``;
the platform rule becomes :func:`default_device`: ``cuda`` when torch
sees a card, an error otherwise (the CPU runs only when asked for with
``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

DEFAULT_SAMPLE_RATE = 48_000.0  # Hz, the reference's fixture rate

# Backend names accepted by CafConfig and the engines.  Every FFT tier
# ('xla', 'matmul*') runs the full-precision complex torch.fft (cuFFT on
# the card, pocketfft on the CPU), which is at least as exact as each
# tier it names.  'pallas', 'pallas-refine' and 'pallas-bf16' run the
# fused filterbank kernels of ops/pallas_caf (csrc/caf_filterbank.cu):
# every tier runs the kernel's f32 FFTs, at least as exact as the
# 3-pass 'high' and single-pass 'bf16' products they name ('refine'
# still re-scores its top bins with a second launch).  'stein*' run the
# segmented engine.
FFT_BACKENDS = ("xla", "matmul", "matmul-highest", "matmul-high",
                "matmul-bf16")
BACKENDS = ("auto",) + FFT_BACKENDS + ("pallas", "pallas-refine",
                                       "pallas-bf16", "stein", "stein-raw")


@dataclasses.dataclass(frozen=True)
class FreqGrid:
    """A doppler search grid: ``[start, stop)`` in ``step`` increments.

    The grid is generated by integer *milli-hertz* stepping so repeated
    float addition never drifts; the stop value is exclusive.
    """

    start_hz: float
    stop_hz: float
    step_hz: float

    def __post_init__(self) -> None:
        if self.step_hz <= 0:
            raise ValueError(f"step_hz must be positive, got {self.step_hz}")
        if self.stop_hz <= self.start_hz:
            raise ValueError("stop_hz must be greater than start_hz")

    @property
    def num_bins(self) -> int:
        start_mhz = int(self.start_hz * 1000.0)
        stop_mhz = int(self.stop_hz * 1000.0)
        step_mhz = int(self.step_hz * 1000.0)
        return max(0, -(-(stop_mhz - start_mhz) // step_mhz))

    def frequencies(self, dtype=np.float64) -> np.ndarray:
        """Materialize the grid as a host array (exact mHz lattice)."""
        start_mhz = int(self.start_hz * 1000.0)
        step_mhz = int(self.step_hz * 1000.0)
        mhz = start_mhz + step_mhz * np.arange(self.num_bins, dtype=np.int64)
        return (mhz.astype(np.float64) / 1e3).astype(dtype)

    def padded(self, multiple: int) -> Tuple["FreqGrid", int]:
        """Extend the grid upward so ``num_bins`` is a multiple of
        ``multiple``: the padded grid and the number of valid (original)
        bins.  The padding bins search real frequencies above the stop."""
        n = self.num_bins
        target = -(-n // multiple) * multiple
        if target == n:
            return self, n
        new_stop = self.start_hz + self.step_hz * target
        return FreqGrid(self.start_hz, new_stop, self.step_hz), n


# The benchmark grid: 400 bins, -100..+100 Hz step 0.5.
BENCH_GRID = FreqGrid(-100.0, 100.0, 0.5)


@dataclasses.dataclass(frozen=True)
class CafConfig:
    """Full configuration for one CAF computation."""

    sample_rate: float = DEFAULT_SAMPLE_RATE
    grid: FreqGrid = BENCH_GRID
    # 'c64' (complex64 compute) or 'c128' (complex128 parity mode).
    precision: str = "c64"
    # One of BACKENDS; 'auto' resolves to 'xla'.
    backend: str = "auto"

    def __post_init__(self) -> None:
        if self.precision not in ("c64", "c128"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def complex_dtype(self):
        return np.complex64 if self.precision == "c64" else np.complex128

    @property
    def real_dtype(self):
        return np.float32 if self.precision == "c64" else np.float64


def default_device() -> torch.device:
    """``cuda`` when torch sees a card; raises ``RuntimeError`` otherwise.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch sees no CUDA card; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_backend(backend) -> str:
    """Validate a backend name; ``None``/'auto' -> 'xla'.

    The FFT tiers 'xla', 'matmul', 'matmul-highest', 'matmul-high' and
    'matmul-bf16' are aliases here: all run the full-precision complex
    ``torch.fft`` (complex64 or complex128), which is at least as exact
    as each tier they name in the JAX package.
    """
    if backend in (None, "auto"):
        return "xla"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def as_grid(freqs_hz, dtype=np.float32) -> np.ndarray:
    """Validated doppler search grid: non-empty 1-D finite array."""
    if isinstance(freqs_hz, torch.Tensor):
        freqs_hz = freqs_hz.detach().cpu().numpy()
    g = np.asarray(freqs_hz, dtype=dtype)
    if g.ndim != 1 or g.size == 0:
        raise ValueError(
            f"frequency grid must be a non-empty 1-D array, got shape "
            f"{g.shape}")
    if not np.all(np.isfinite(g)):
        raise ValueError("frequency grid contains non-finite values")
    return g


def signal_grid(freqs_hz, signal: torch.Tensor) -> np.ndarray:
    """:func:`as_grid` in the real dtype of ``signal``'s samples: float64
    for complex128 signals, float32 otherwise."""
    return as_grid(freqs_hz, dtype=np.float64
                   if signal.dtype == torch.complex128 else np.float32)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def xcor_length(needle_len: int) -> int:
    """Zero-padded cross-correlation length: 2N rounded up to a power
    of two."""
    return next_pow2(2 * needle_len)


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def floor_pow2(n: int) -> int:
    """Largest power of two <= n (0 for n <= 0)."""
    if n <= 0:
        return 0
    while not is_pow2(n):
        n &= n - 1
    return n


def log2_int(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"{n} is not a power of two")
    return int(math.log2(n) + 0.5)
