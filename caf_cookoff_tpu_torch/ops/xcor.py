"""FFT cross-correlation with the reference's (Rust path) conventions.

* both operands are zero-padded by appending zeros to ``M >= 2N``;
* the result is ``ifft(fft(a) * conj(fft(b)))`` with one ``1/M``
  normalization (``torch.fft.ifft``'s default, as numpy's);
* operand order: ``a = haystack``, ``b = shifted needle``, so a positive
  lag D lands at raw index D.
"""

from __future__ import annotations

from typing import Optional

import torch

from caf_cookoff_tpu_torch.config import xcor_length
from caf_cookoff_tpu_torch.ops.shift import phasor_bank, real_dtype_of


def pad_to(x: torch.Tensor, length: int) -> torch.Tensor:
    """Append zeros along the last axis up to ``length``."""
    n = x.shape[-1]
    if length < n:
        raise ValueError(f"cannot pad length {n} down to {length}")
    if length == n:
        return x
    out = x.new_zeros(*x.shape[:-1], length)
    out[..., :n] = x
    return out


def xcor_pair(a: torch.Tensor, b: torch.Tensor,
              length: Optional[int] = None) -> torch.Tensor:
    """Complex circular cross-correlation of two equal-length signals:
    ``r[tau] = sum_s a[s+tau] * conj(b[s])`` over a zero-padded length
    (default ``xcor_length(N)``)."""
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"length mismatch: {a.shape[-1]} vs {b.shape[-1]}")
    m = length or xcor_length(a.shape[-1])
    fa = torch.fft.fft(pad_to(a, m), dim=-1)
    fb = torch.fft.fft(pad_to(b, m), dim=-1)
    return torch.fft.ifft(fa * torch.conj(fb), dim=-1)


def xcor(apple: torch.Tensor, banana: torch.Tensor) -> torch.Tensor:
    """Magnitude cross-correlation in scipy ``mode='same'`` layout
    (output length N, lag ``tau = N//2 - argmax``) — the Python
    reference's flavor."""
    n = apple.shape[-1]
    m = xcor_length(n)
    circ = torch.fft.ifft(
        torch.fft.fft(pad_to(apple, m), dim=-1)
        * torch.conj(torch.fft.fft(pad_to(banana, m), dim=-1)), dim=-1)
    lags = (torch.arange(n, device=circ.device) - n // 2) % m
    return torch.abs(circ[..., lags])


def xcor_bank(haystack_spectrum: torch.Tensor,
              shifted_padded: torch.Tensor) -> torch.Tensor:
    """Batched xcor rows: one haystack spectrum (M,) vs K zero-padded
    shifted needles (K, M) -> (K, M) complex rows."""
    fs = torch.fft.fft(shifted_padded, dim=-1)
    return torch.fft.ifft(haystack_spectrum[None, :] * torch.conj(fs),
                          dim=-1)


def mag2(rows: torch.Tensor) -> torch.Tensor:
    """|.|^2 of complex rows as re*re + im*im."""
    return rows.real * rows.real + rows.imag * rows.imag


def _surface_rows(needle: torch.Tensor, haystack: torch.Tensor, freqs_hz,
                  sample_rate, xcor_len: int) -> torch.Tensor:
    """Complex correlation rows (..., K, M) of needles (..., N) against
    haystacks (..., L <= M) at frequencies (..., K) — the filterbank's
    rows for one pair, or a batch of pairs each with its own bins; also
    the exact re-score rows of the Stein engines.  The phasor is
    evaluated over the N needle samples only (the padding is zeros)."""
    m = xcor_len
    rdtype = real_dtype_of(needle.dtype)
    h_spec = torch.fft.fft(pad_to(haystack, m))
    shifted = needle[..., None, :] * phasor_bank(
        torch.as_tensor(freqs_hz, dtype=rdtype, device=needle.device),
        needle.shape[-1], sample_rate, rdtype, needle.device)
    s_spec = torch.fft.fft(pad_to(shifted, m), dim=-1)
    return torch.fft.ifft(h_spec[..., None, :] * torch.conj(s_spec), dim=-1)
