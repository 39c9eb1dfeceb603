"""Stein time-segmented CAF — fast fine-grid doppler search.

    r_k[tau] = sum_s h[s+tau] conj(n[s]) e^{-j w_k s}
             ~ sum_b e^{-j w_k (bD + c)} * G[b, tau]
      where  G[b, tau] = sum_{d<D} h[bD+d+tau] conj(n[bD+d]),  c = (D-1)/2

* Stage A — segment correlations ``G`` (B = N/D needle blocks against
  the haystack).
* Stage B — doppler synthesis ``R = W @ G``.

The main path (:func:`stein_caf_peak`, ``fused`` on wherever eligible)
runs both stages and the per-bin rank in the fused kernel
(``ops/fused_stein``), then re-scores the top candidate bins with exact
filterbank rows, which restores bin-exact answers.  ``fused=False``
runs the FFT stage A and a matmul synthesis instead.

The block-constant phase approximation attenuates doppler responses by
``sinc(w_k D / 2)``; :func:`_auto_block_len` keeps ``D <= fs/(4 f_max)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (as_grid, floor_pow2,
                                          resolve_backend, xcor_length)
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models.batched_stein import (_haystack_extension,
                                                        _needle_operator)
from caf_cookoff_tpu_torch.models.filterbank import _surface_rows, mag2
from caf_cookoff_tpu_torch.ops.fused_stein import (SUPER, fused_span,
                                                   fused_stein_rank,
                                                   stein_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, doppler_cell_bins,
                                            find_peak_2d, topk_separated)
from caf_cookoff_tpu_torch.ops.shift import real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal

# Candidates of the exact re-score: _REFINE_BINS plain top-k picks
# (adjacent near-tie flips) plus _REFINE_SEP_BINS mainlobe-separated
# picks (distinct lobes on grids finer than the fs/N mainlobe).
_REFINE_BINS = 8
_REFINE_SEP_BINS = 4


def _segment_correlations(needle: torch.Tensor, haystack: torch.Tensor,
                          xcor_len: int, block_len: int) -> torch.Tensor:
    """G (B, M) complex: per-needle-block correlations vs the haystack,
    each block's spectrum twisted to its true offset (shift theorem)."""
    n = needle.shape[-1]
    d = block_len
    b = -(-n // d)
    m = xcor_len
    rdtype = real_dtype_of(needle.dtype)
    np_rdtype = np.float64 if rdtype == torch.float64 else np.float32
    blocks = pad_to(needle, b * d).reshape(b, d)
    s0 = torch.fft.fft(pad_to(blocks, m), dim=-1)         # at-origin
    ang = (-2.0 * np.pi / m) * (np.arange(b)[:, None] * d
                                * np.arange(m)[None, :])
    twist = torch.complex(
        torch.from_numpy(np.cos(ang).astype(np_rdtype)),
        torch.from_numpy(np.sin(ang).astype(np_rdtype))).to(needle.device)
    s_b = s0 * twist
    h_spec = torch.fft.fft(pad_to(haystack, m))
    return torch.fft.ifft(h_spec[None, :] * torch.conj(s_b), dim=-1)


def _doppler_synthesis(g: torch.Tensor, freqs_hz: torch.Tensor,
                       sample_rate, block_len: int):
    """R = W @ G as one stacked real matmul over the segment axis;
    returns (Rr, Ri), each (K, M)."""
    gr, gi = g.real, g.imag
    b = gr.shape[0]
    rdtype = gr.dtype
    dev = g.device
    centers = torch.as_tensor(
        np.arange(b) * block_len + (block_len - 1) / 2.0, dtype=rdtype,
        device=dev)
    scale = (torch.tensor(-2.0 * math.pi, dtype=rdtype, device=dev)
             / torch.tensor(sample_rate, dtype=rdtype, device=dev))
    w = scale * torch.outer(freqs_hz.to(rdtype), centers)  # (K, B) phase
    wr, wi = torch.cos(w), torch.sin(w)
    ws = torch.cat([torch.cat([wr, -wi], dim=1),
                    torch.cat([wi, wr], dim=1)], dim=0)   # (2K, 2B)
    gs = torch.cat([gr, gi], dim=0)                       # (2B, M)
    rs = ws @ gs                                          # (2K, M)
    k = wr.shape[0]
    return rs[:k], rs[k:]


def _stein_rows(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                block_len: int):
    g = _segment_correlations(needle, haystack, xcor_len, block_len)
    return _doppler_synthesis(g, freqs_hz, sample_rate, block_len)


def _fused_operands(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                    block_len: int):
    """The fused kernel's f32 operands for one pair:
    ``((ws1, ws2, lmat, h_ext), num_blocks, sup)``.  The needle is padded
    to a multiple of SUPER first, as in the JAX package."""
    nr = pad_to(needle, needle.shape[-1] + (-needle.shape[-1]) % SUPER)
    b = nr.shape[-1] // block_len
    lmat, sup = _needle_operator(nr.real[None], nr.imag[None], block_len)
    span = fused_span(b, sup, xcor_len)
    h_ext = _haystack_extension(haystack.real[None], haystack.imag[None],
                                xcor_len, span)
    ws1, ws2 = stein_synthesis_weights(freqs_hz, sample_rate, b, block_len)
    return (ws1, ws2, lmat.float(), h_ext.float()), b, sup


def _fused_rowmax(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                  block_len: int) -> torch.Tensor:
    """(K,) coarse per-bin max |R|^2 through the fused kernel."""
    ops, b, sup = _fused_operands(needle, haystack, freqs_hz, sample_rate,
                                  xcor_len, block_len)
    vals, _ = fused_stein_rank(*ops, b, sup, xcor_len, want_idxs=False)
    return vals[:, 0]


def _stein_peak(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                block_len: int, refine: bool = True,
                fused: bool = False) -> CafPeak:
    if refine and fused:
        rowmax = _fused_rowmax(needle, haystack, freqs_hz, sample_rate,
                               xcor_len, block_len)
    else:
        rows = _stein_rows(needle, haystack, freqs_hz, sample_rate,
                           xcor_len, block_len)
        surface = rows[0] * rows[0] + rows[1] * rows[1]
        if not refine:
            return find_peak_2d(surface)
        rowmax = torch.amax(surface, dim=-1)
    return _refine_topk(needle, haystack, freqs_hz, rowmax, sample_rate,
                        xcor_len)


def _refine_candidates(rowmax_coarse: torch.Tensor, freqs_all: torch.Tensor,
                       needle_len: int, sample_rate) -> torch.Tensor:
    """Candidate bins of the exact re-score for a (K,) ranking: the plain
    top-k (equal values lowest bin first, as ``jax.lax.top_k``) followed
    by a mainlobe-separated top-k.  Duplicates are harmless."""
    k = min(_REFINE_BINS, int(rowmax_coarse.shape[-1]))
    cand = torch.sort(rowmax_coarse, descending=True,
                      stable=True).indices[:k].to(torch.int32)
    ksep = min(_REFINE_SEP_BINS, k)
    sep = doppler_cell_bins(freqs_all, needle_len, sample_rate)
    cand_sep = topk_separated(rowmax_coarse, ksep, sep)
    return torch.cat([cand, cand_sep])


def _refine_topk(needle, haystack, freqs_all, rowmax_coarse, sample_rate,
                 xcor_len: int) -> CafPeak:
    """Exact re-score of the coarse ranking: highest exact value wins,
    exact ties break toward the lowest bin."""
    cand = _refine_candidates(rowmax_coarse, freqs_all, needle.shape[-1],
                              sample_rate)
    exact = mag2(_surface_rows(needle, haystack, freqs_all[cand.long()],
                               sample_rate, xcor_len))       # (k, M)
    rowmax = torch.amax(exact, dim=-1)
    top = rowmax == torch.amax(rowmax)
    winner = torch.amin(torch.where(top, cand, torch.iinfo(torch.int32).max))
    best = torch.argmax((top & (cand == winner)).to(torch.int8))
    return CafPeak(value=rowmax[best], freq_idx=cand[best],
                   lag_idx=torch.argmax(exact[best]).to(torch.int32))


def _auto_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Clamp the segment length to the approximation's validity range:
    the block-constant phase error ``w_max * D / 2`` stays under ~pi/8
    when ``D <= fs / (4 * f_max)``."""
    f_max = float(np.max(np.abs(freqs_hz))) if len(freqs_hz) else 0.0
    if f_max <= 0:
        return requested
    limit = int(sample_rate / (4.0 * f_max))
    d = min(requested, max(limit, 1))
    if d < 8:
        raise SpanError(
            f"doppler span +-{f_max:.0f} Hz needs segment length <= {limit} "
            f"(< 8) at fs={sample_rate:.0f}; the segmented (stein) engine "
            "does not pay off — use the 'xla' (filterbank) backend")
    return d


def _prep(needle, haystack, freqs_hz, device):
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    n_len, h_len = n.shape[-1], h.shape[-1]
    # The haystack may run up to the M-point correlation length (the
    # engines zero-pad it to M anyway).
    if h_len < n_len or h_len > xcor_length(n_len):
        raise ValueError(
            f"haystack length {h_len} outside [{n_len}, "
            f"{xcor_length(n_len)}] for needle length {n_len}")
    rdtype = np.float64 if n.dtype == torch.complex128 else np.float32
    freqs = as_grid(freqs_hz, dtype=rdtype)
    return n, h, freqs, torch.from_numpy(freqs).to(n.device)


def _block_len_or_raise(sample_rate, freqs, block_len: int) -> int:
    try:
        return _auto_block_len(sample_rate, freqs, block_len)
    except SpanError as exc:
        raise SpanError(
            f"{exc}; the banded Stein engine that covers wider spans is "
            "not ported yet (ROADMAP Queue 1 item 4)") from exc


def stein_caf_surface(needle, haystack, freqs_hz, sample_rate, *,
                      block_len: int = 64, backend: Optional[str] = None,
                      device=None) -> torch.Tensor:
    """(K, M) mag^2 surface via time segmentation (Stein's method)."""
    resolve_backend(backend)
    n, h, freqs, freqs_t = _prep(needle, haystack, freqs_hz, device)
    block_len = _auto_block_len(sample_rate, freqs, block_len)
    rr, ri = _stein_rows(n, h, freqs_t, float(sample_rate),
                         xcor_length(n.shape[-1]), block_len)
    return rr * rr + ri * ri


def stein_caf_peak(needle, haystack, freqs_hz, sample_rate, *,
                   block_len: int = 64, refine: bool = True,
                   fused: Optional[bool] = None,
                   backend: Optional[str] = None,
                   device=None) -> Tuple[float, int, float]:
    """(freq_hz, lag, value) via the segmented fast path.

    ``refine=True`` (default) re-scores the top candidate bins with the
    exact filterbank rows.  ``fused=None`` selects the fused coarse-rank
    kernel wherever the shape is eligible (a pow2 block length >= 8 and
    a 512-multiple correlation length), on every device: on CUDA
    tensors it launches the kernel, on CPU tensors its plain version.
    Every FFT ``backend`` name runs ``torch.fft``.
    """
    resolve_backend(backend)
    n, h, freqs, freqs_t = _prep(needle, haystack, freqs_hz, device)
    xl = xcor_length(n.shape[-1])
    block_len = _block_len_or_raise(sample_rate, freqs, block_len)
    d_fused = floor_pow2(min(block_len, SUPER))
    eligible = refine and d_fused >= 8 and xl % 512 == 0
    if fused is None:
        fused = eligible
    if fused:
        if not eligible:
            raise EligibilityError(
                f"fused kernel needs refine=True, a pow2 block length "
                f">= 8 (got {block_len} -> {d_fused}) and a 512-multiple "
                f"correlation length (got {xl}); use fused=False")
        block_len = d_fused
    peak = _stein_peak(n, h, freqs_t, float(sample_rate), xl, block_len,
                       refine, fused)
    return (float(freqs[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))
