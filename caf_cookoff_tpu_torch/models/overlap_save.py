"""Overlap-save segmented correlation — long-haystack CAF.

The haystack is cut into blocks of ``V`` lags with ``N-1``-sample
forward halos; each block is a circular FFT correlation against the
doppler-shifted needle bank, and blocks stitch into a ``(K, L-N+1)``
linear-correlation surface.

Block math: with FFT size ``M = xcor_length(N)`` and ``V = M - N`` lags
per block, block ``b`` reads haystack samples ``[bV, bV + V + N - 1)``
(zero-padded at the tail), so circular lag ``i < V`` of the block equals
linear lag ``bV + i`` of the full correlation — no wrap contamination.

The doppler-shifted needle spectra are computed once and reused across
blocks.  The JAX package's ``lax.scan`` over blocks is a Python loop
here; the peak carry stays on the device (no host sync per block), and
the strict ``>`` keeps the earliest block on ties.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import as_grid, resolve_backend, xcor_length
from caf_cookoff_tpu_torch.models.filterbank import mag2
from caf_cookoff_tpu_torch.ops.peak import CafPeak, find_peak_2d
from caf_cookoff_tpu_torch.ops.shift import phasor_bank, real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal


def plan_blocks(needle_len: int, num_lags: int) -> Tuple[int, int, int]:
    """(fft_len M, lags_per_block V, num_blocks B) for a lag count."""
    m = xcor_length(needle_len)
    v = m - needle_len
    b = -(-num_lags // v)
    return m, v, b


def needle_spectra_conj(needle: torch.Tensor, freqs_hz: torch.Tensor,
                        sample_rate, fft_len: int) -> torch.Tensor:
    """conj(FFT(padded shifted needle bank)) — (K, M) complex, computed
    once.  The phase is ``2*pi*(f/fs) * n`` in the needle's real dtype."""
    rdtype = real_dtype_of(needle.dtype)
    shifted = needle[None, :] * phasor_bank(freqs_hz, needle.shape[-1],
                                            sample_rate, rdtype,
                                            needle.device)
    return torch.conj(torch.fft.fft(pad_to(shifted, fft_len), dim=-1))


def _block_rows(hay: torch.Tensor, s_conj: torch.Tensor, b: int, v: int,
                d: int, m: int) -> torch.Tensor:
    """(K, V) mag^2 rows of block ``b``: local lags [b*V, b*V + V)."""
    spec = torch.fft.fft(pad_to(hay[b * v:b * v + d], m))
    rows = torch.fft.ifft(spec[None, :] * s_conj, dim=-1)
    return mag2(rows[..., :v])


def streaming_peak(s_conj: torch.Tensor, haystack: torch.Tensor,
                   needle_len: int, num_lags: int, lag_offset: int = 0,
                   total_lags: Optional[int] = None,
                   valid_rows: Optional[torch.Tensor] = None,
                   with_floor: bool = False):
    """Block-loop peak of ``num_lags`` local lags (single-peak path of
    the JAX package's ``streaming_peak``).

    ``lag_offset`` shifts local lags to global lag indices; lags at or
    beyond ``total_lags`` (global) are masked out so zero-padded tails
    cannot win.  ``valid_rows`` ((K,) bool) masks whole doppler rows.
    Returns a :class:`CafPeak` (0-d tensors) with the global lag;
    ``with_floor=True`` also returns ``(floor_sum, floor_count)`` over
    every valid cell (f32 sums, one per block)."""
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    d = v + needle_len - 1
    target = nblocks * v + needle_len - 1
    # Samples past the last block's reach cannot affect the lags.
    hay = (haystack[..., :target] if haystack.shape[-1] >= target
           else pad_to(haystack, target))
    rdtype = real_dtype_of(s_conj.dtype)
    dev = s_conj.device
    best = CafPeak(value=torch.tensor(-math.inf, dtype=rdtype, device=dev),
                   freq_idx=torch.zeros((), dtype=torch.int32, device=dev),
                   lag_idx=torch.zeros((), dtype=torch.int32, device=dev))
    fsum = torch.zeros((), dtype=rdtype, device=dev)
    fcnt = torch.zeros((), dtype=rdtype, device=dev)
    local = torch.arange(v, dtype=torch.int32, device=dev)
    for b in range(nblocks):
        rows = _block_rows(hay, s_conj, b, v, d, m)
        keep = (local + b * v < num_lags)[None, :]
        if total_lags is not None:
            keep = keep & (local + b * v + lag_offset < total_lags)[None, :]
        if valid_rows is not None:
            keep = keep & valid_rows[:, None]
        if with_floor:
            keep_b = keep.expand(rows.shape)
            fsum = fsum + torch.sum(torch.where(keep_b, rows, 0.0))
            fcnt = fcnt + torch.sum(keep_b.to(rdtype))
        cand = find_peak_2d(torch.where(keep, rows, -1.0))
        take = cand.value > best.value    # strict: earlier block wins ties
        best = CafPeak(
            value=torch.where(take, cand.value, best.value),
            freq_idx=torch.where(take, cand.freq_idx, best.freq_idx),
            lag_idx=torch.where(take, cand.lag_idx + b * v, best.lag_idx))
    peak = CafPeak(best.value, best.freq_idx, best.lag_idx + lag_offset)
    if with_floor:
        return peak, fsum, fcnt
    return peak


def _prep(needle, haystack, freqs_hz, device):
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    if h.shape[-1] < n.shape[-1]:
        raise ValueError(f"haystack ({h.shape[-1]}) shorter than needle "
                         f"({n.shape[-1]})")
    rdtype = np.float64 if n.dtype == torch.complex128 else np.float32
    freqs = as_grid(freqs_hz, dtype=rdtype)
    return n, h, freqs, torch.from_numpy(freqs).to(n.device)


def overlap_save_surface(needle, haystack, freqs_hz, sample_rate,
                         num_lags: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device=None) -> torch.Tensor:
    """(K, num_lags) linear-correlation CAF surface for a long haystack;
    ``num_lags`` defaults to the full-overlap range ``L - N + 1``."""
    resolve_backend(backend)
    n, h, _, freqs_t = _prep(needle, haystack, freqs_hz, device)
    nl = n.shape[-1]
    lags = num_lags or h.shape[-1] - nl + 1
    m, v, nblocks = plan_blocks(nl, lags)
    s_conj = needle_spectra_conj(n, freqs_t, float(sample_rate), m)
    hay = pad_to(h, max(h.shape[-1], nblocks * v + nl - 1))
    surf = torch.cat([_block_rows(hay, s_conj, b, v, v + nl - 1, m)
                      for b in range(nblocks)], dim=-1)
    return surf[:, :lags]


def mean_floor(floor_sum, floor_count):
    """Mean mag^2 over all searched cells from the scan's accumulators
    (scalars, or per-pair arrays)."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else x
    return (np.asarray(host(floor_sum), np.float64)
            / np.maximum(np.asarray(host(floor_count), np.float64), 1.0))


def overlap_save_peak(needle, haystack, freqs_hz, sample_rate,
                      num_lags: Optional[int] = None, *,
                      backend: Optional[str] = None,
                      with_snr: bool = False, device=None):
    """(freq_hz, lag, value) peak of the long-haystack CAF.

    Streams the blocks, so the full surface never materializes.
    ``with_snr=True`` appends the peak-to-floor ratio in dB (the floor is
    the mean mag^2 over every searched cell, accumulated in the same
    loop): ``(freq_hz, lag, value, snr_db)``.
    """
    resolve_backend(backend)
    n, h, freqs, freqs_t = _prep(needle, haystack, freqs_hz, device)
    nl = n.shape[-1]
    lags = num_lags or h.shape[-1] - nl + 1
    m, _, _ = plan_blocks(nl, lags)
    s_conj = needle_spectra_conj(n, freqs_t, float(sample_rate), m)
    out = streaming_peak(s_conj, h, nl, lags, with_floor=with_snr)
    peak = out[0] if with_snr else out
    result = (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
              float(peak.value))
    if not with_snr:
        return result
    floor = float(mean_floor(out[1], out[2]))
    value = result[2]
    snr_db = (10.0 * float(np.log10(value / max(floor, 1e-300)))
              if value > 0 else float("-inf"))
    return result + (snr_db,)
