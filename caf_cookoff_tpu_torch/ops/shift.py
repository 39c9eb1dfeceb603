"""Frequency translation (doppler shift) ops.

``x[n] * exp(j*2*pi*f*n/fs)`` as one vectorized expression; a bank of K
shifts is a single (K, N) broadcast.  The phase is computed in the
signal's real dtype, in the JAX package's order: ``rate = 2*pi*(f/fs)``
first, then ``rate * n``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """float32 for complex64/float32, float64 for complex128/float64."""
    return torch.float64 if dtype in (torch.complex128,
                                      torch.float64) else torch.float32


def numpy_real(dtype: torch.dtype):
    """numpy's float64 for torch.float64, else float32."""
    return np.float64 if dtype == torch.float64 else np.float32


def _phase_ramp(freq_hz, num_samples: int, sample_rate, real_dtype,
                device) -> torch.Tensor:
    """2*pi*f*n/fs for n in [0, num_samples), shaped (..., num_samples).

    Nothing is copied to the card for a tensor grid: ``fs`` is a 0-d
    tensor filled there, so ``f / fs`` is a true division (a Python
    divisor would be a reciprocal product on the card).  Host
    frequencies take their rate in numpy in ``real_dtype`` (IEEE, as on
    the card)."""
    n = torch.arange(num_samples, dtype=real_dtype, device=device)
    two_pi = numpy_real(real_dtype)(2.0 * math.pi)
    if isinstance(freq_hz, torch.Tensor):
        f = freq_hz.to(device=device, dtype=real_dtype)
        rate = float(two_pi) * (f / f.new_full((), sample_rate))
    else:
        np_dt = numpy_real(real_dtype)
        rate = two_pi * (np.asarray(freq_hz, np_dt) / np_dt(sample_rate))
        if rate.ndim == 0:
            return float(rate) * n
        rate = torch.from_numpy(rate).to(device, non_blocking=True)
    return rate[..., None] * n if rate.ndim else rate * n


def _phasor(phase: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(phase), torch.sin(phase))


def freq_shift(x: torch.Tensor, freq_hz, sample_rate) -> torch.Tensor:
    """Return ``x * exp(j*2*pi*freq_hz*n/sample_rate)``."""
    phase = _phase_ramp(freq_hz, x.shape[-1], sample_rate,
                        real_dtype_of(x.dtype), x.device)
    return x * _phasor(phase)


# Alias matching the Python reference's name.
apply_fdoa = freq_shift


def phasor_bank(freqs_hz, num_samples: int, sample_rate,
                real_dtype=torch.float32, device=None) -> torch.Tensor:
    """(K, num_samples) complex phasor matrix ``exp(j*2*pi*f_k*n/fs)``."""
    if device is None and isinstance(freqs_hz, torch.Tensor):
        device = freqs_hz.device
    return _phasor(_phase_ramp(freqs_hz, num_samples, sample_rate,
                               real_dtype, device))


def shift_bank(x: torch.Tensor, freqs_hz, sample_rate) -> torch.Tensor:
    """Apply every frequency in ``freqs_hz`` to ``x`` at once -> (K, N)."""
    return x[None, :] * phasor_bank(freqs_hz, x.shape[-1], sample_rate,
                                    real_dtype_of(x.dtype), x.device)
