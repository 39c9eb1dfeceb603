"""Filterbank CAF surface engine.

One batched tensor program over the doppler axis, with the haystack FFT
hoisted out of the bin loop (Rust reference semantics):

    needle (N,), haystack (N,)  --pad-->  (M = xcor_length(N),)
    H = fft(haystack_pad)                          # once
    S_k = fft(pad(needle * exp(j 2 pi f_k n / fs)))  # batched over K
    r_k = ifft(H * conj(S_k))                      # batched over K
    surface[k, tau] = |r_k[tau]|^2
    peak = argmax_{k, tau} surface (lowest flat index on ties)

Every FFT backend name runs ``torch.fft`` (cuFFT on the card); the
``pallas*`` names run the fused filterbank kernels K2/K3
(``ops/pallas_caf``), whose peak value is unnormalised (M^2 times the
``xla`` value), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (CafConfig, as_grid,
                                          resolve_backend, xcor_length)
from caf_cookoff_tpu_torch.ops.pallas_caf import (pallas_caf_peak,
                                                  pallas_caf_surface)
from caf_cookoff_tpu_torch.ops.peak import find_peak_2d
from caf_cookoff_tpu_torch.ops.shift import phasor_bank, real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal
from caf_cookoff_tpu_torch.utils.profiling import span


def mag2(rows: torch.Tensor) -> torch.Tensor:
    """|.|^2 of complex rows as re*re + im*im."""
    return rows.real * rows.real + rows.imag * rows.imag


def _surface_rows(needle: torch.Tensor, haystack: torch.Tensor, freqs_hz,
                  sample_rate, xcor_len: int) -> torch.Tensor:
    """Complex correlation rows (..., K, M) of needles (..., N) against
    haystacks (..., L <= M) at frequencies (..., K) — one pair, or a
    batch of pairs each with its own bins; also the exact re-score rows
    of the Stein engines.  The phasor is evaluated over the N needle
    samples only (the padding is zeros)."""
    m = xcor_len
    rdtype = real_dtype_of(needle.dtype)
    h_spec = torch.fft.fft(pad_to(haystack, m))
    shifted = needle[..., None, :] * phasor_bank(
        torch.as_tensor(freqs_hz, dtype=rdtype, device=needle.device),
        needle.shape[-1], sample_rate, rdtype, needle.device)
    s_spec = torch.fft.fft(pad_to(shifted, m), dim=-1)
    return torch.fft.ifft(h_spec[..., None, :] * torch.conj(s_spec), dim=-1)


def _pair(needle, haystack, freqs_hz, device):
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    if n.shape[-1] != h.shape[-1]:
        raise ValueError(
            f"needle/haystack length mismatch: {n.shape[-1]} vs "
            f"{h.shape[-1]} (truncate the haystack to the needle length)")
    rdtype = np.float64 if n.dtype == torch.complex128 else np.float32
    return n, h, as_grid(freqs_hz, dtype=rdtype)


def caf_surface(needle, haystack, freqs_hz, sample_rate, *,
                backend: Optional[str] = None,
                device=None) -> torch.Tensor:
    """The (K, M) magnitude-squared CAF surface on ``device``."""
    backend = resolve_backend(backend)
    if backend.startswith("stein"):
        from caf_cookoff_tpu_torch.models.stein import stein_caf_surface

        return stein_caf_surface(needle, haystack, freqs_hz, sample_rate,
                                 device=device)
    n, h, freqs = _pair(needle, haystack, freqs_hz, device)
    if backend.startswith("pallas"):
        _, _, tier = backend.partition("-")
        return pallas_caf_surface(
            n, h, freqs, float(sample_rate), xcor_length(n.shape[-1]),
            precision="bf16" if tier == "bf16" else "high")
    return mag2(_surface_rows(n, h, freqs, float(sample_rate),
                              xcor_length(n.shape[-1])))


def find_peak(surface, freqs_hz) -> Tuple[float, int]:
    """(frequency_hz, raw lag index) of the surface peak."""
    peak = find_peak_2d(torch.as_tensor(surface))
    freqs = np.asarray(freqs_hz)
    return float(freqs[int(peak.freq_idx)]), int(peak.lag_idx)


def caf_peak(needle, haystack, freqs_hz, sample_rate, *,
             backend: Optional[str] = None,
             device=None) -> Tuple[float, int, float]:
    """(freq_hz, lag_idx, peak_value) of one (needle, haystack) pair.

    ``backend='stein'`` (the main path) runs the segmented engine with
    the fused coarse-rank kernel and an exact re-score; ``pallas*`` run
    the fused filterbank kernel (tier after the dash, default ``high``);
    the FFT backends run the filterbank on ``torch.fft``.
    """
    backend = resolve_backend(backend)
    if backend.startswith("stein"):
        from caf_cookoff_tpu_torch.models.stein import stein_caf_peak

        # stein_caf_peak opens the call's one caf.call span.
        return stein_caf_peak(needle, haystack, freqs_hz, sample_rate,
                              refine=not backend.endswith("-raw"),
                              device=device)
    with span("caf.call"):
        with span("caf.prep"):
            n, h, freqs = _pair(needle, haystack, freqs_hz, device)
        if backend.startswith("pallas"):
            _, _, tier = backend.partition("-")
            peak = pallas_caf_peak(n, h, freqs, float(sample_rate),
                                   xcor_length(n.shape[-1]),
                                   precision=tier or "high")
        else:
            peak = find_peak_2d(mag2(_surface_rows(
                n, h, freqs, float(sample_rate), xcor_length(n.shape[-1]))))
        with span("caf.read"):
            return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
                    float(peak.value))


def amb_surf(needle, haystack, freqs_hz, samp_rate,
             device=None) -> torch.Tensor:
    """Python-reference-compatible (K, N) |xcor| rows in scipy
    ``mode='same'`` layout: ``tau = N//2 - argmax`` recovers the lag.
    The xcor is correlate(shifted_needle, haystack): conjugation on the
    haystack side, opposite of the Rust path."""
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    rdtype = real_dtype_of(n.dtype)
    length = n.shape[-1]
    m = xcor_length(length)
    shifted = pad_to(n, m)[None, :] * phasor_bank(
        torch.as_tensor(np.asarray(freqs_hz), dtype=rdtype, device=n.device),
        m, float(samp_rate), rdtype, n.device)
    h_spec = torch.fft.fft(pad_to(h, m))
    rows = torch.fft.ifft(torch.fft.fft(shifted, dim=-1)
                          * torch.conj(h_spec)[None, :], dim=-1)
    lags = torch.as_tensor((np.arange(length) - length // 2) % m,
                           device=n.device)
    return torch.abs(rows[..., lags])


class FilterbankCAF:
    """Config-bound engine object.

    >>> engine = FilterbankCAF(CafConfig())
    >>> surface = engine.surface(needle, haystack)
    >>> freq, lag = engine.peak(needle, haystack)
    """

    def __init__(self, config: Optional[CafConfig] = None, device=None):
        self.config = config or CafConfig()
        self.device = device
        self._freqs = self.config.grid.frequencies(self.config.real_dtype)

    @property
    def frequencies(self) -> np.ndarray:
        return self._freqs

    def _cast(self, x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=self.config.complex_dtype)

    def surface(self, needle, haystack) -> torch.Tensor:
        return caf_surface(self._cast(needle), self._cast(haystack),
                           self._freqs, self.config.sample_rate,
                           backend=self.config.backend, device=self.device)

    def peak(self, needle, haystack) -> Tuple[float, int]:
        freq, lag, _ = caf_peak(self._cast(needle), self._cast(haystack),
                                self._freqs, self.config.sample_rate,
                                backend=self.config.backend,
                                device=self.device)
        return freq, lag
