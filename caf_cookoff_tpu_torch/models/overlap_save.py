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
the strict ``>`` keeps the earliest block on ties.  With ``num_peaks >
1`` the carry is a top-``num_peaks`` NMS lattice (the multi-emitter
lattice scan: the cuFFT fallback and oracle of the fused lattice
engines); a leading pair axis runs a batch of pairs in one loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (resolve_backend, signal_grid,
                                          xcor_length)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, apply_detection_threshold,
                                            as_lattice, concat_peaks,
                                            find_peak_2d, find_peaks,
                                            merge_peaks, resolve_exclusions)
from caf_cookoff_tpu_torch.ops.shift import phasor_bank, real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import mag2, pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal


def plan_blocks(needle_len: int, num_lags: int) -> Tuple[int, int, int]:
    """(fft_len M, lags_per_block V, num_blocks B) for a lag count."""
    m = xcor_length(needle_len)
    v = m - needle_len
    b = -(-num_lags // v)
    return m, v, b


def needle_spectra_conj(needle: torch.Tensor, freqs_hz: torch.Tensor,
                        sample_rate, fft_len: int) -> torch.Tensor:
    """conj(FFT(padded shifted needle bank)) — (..., K, M) complex for
    (..., N) needles, computed once.  The phase is ``2*pi*(f/fs) * n``
    in the needle's real dtype."""
    rdtype = real_dtype_of(needle.dtype)
    shifted = needle[..., None, :] * phasor_bank(
        freqs_hz, needle.shape[-1], sample_rate, rdtype, needle.device)
    return torch.conj(torch.fft.fft(pad_to(shifted, fft_len), dim=-1))


def _block_rows(hay: torch.Tensor, s_conj: torch.Tensor, b: int, v: int,
                d: int, m: int) -> torch.Tensor:
    """(..., K, V) mag^2 rows of block ``b``: local lags [b*V, b*V + V)."""
    spec = torch.fft.fft(pad_to(hay[..., b * v:b * v + d], m))
    rows = torch.fft.ifft(spec[..., None, :] * s_conj, dim=-1)
    return mag2(rows[..., :v])


def streaming_peak(s_conj: torch.Tensor, haystack: torch.Tensor,
                   needle_len: int, num_lags: int, lag_offset: int = 0,
                   total_lags: Optional[int] = None, num_peaks: int = 1,
                   exclude_freq: Optional[int] = None,
                   exclude_lag: Optional[int] = None,
                   valid_rows: Optional[torch.Tensor] = None,
                   with_floor: bool = False):
    """Block-loop peak of ``num_lags`` local lags (the JAX package's
    ``streaming_peak``); ``s_conj`` (..., K, M) and ``haystack`` (..., L)
    may carry a leading pair axis.

    ``lag_offset`` shifts local lags to global lag indices; lags at or
    beyond ``total_lags`` (global) are masked out so zero-padded tails
    cannot win.  ``valid_rows`` ((K,) bool) masks whole doppler rows.
    Returns a :class:`CafPeak` (fields (...)) with the global lag;
    ``with_floor=True`` also returns ``(floor_sum, floor_count)`` over
    every valid cell (f32 sums, one per block).

    ``num_peaks > 1`` carries a top-``num_peaks`` lattice instead (fields
    (..., num_peaks), strongest first, empty slots -inf): each block's
    masked lags become -inf, :func:`find_peaks` takes its NMS'd peaks
    and :func:`merge_peaks` folds them into the carry, so an emitter
    straddling a block edge collapses to one entry.  The exclusion
    windows are then required (:func:`resolve_exclusions`)."""
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    lattice = num_peaks > 1
    if lattice and (exclude_freq is None or exclude_lag is None):
        raise ValueError(
            "num_peaks > 1 needs explicit NMS exclusion windows — derive "
            "them from the waveform via ops.peak.resolve_exclusions")
    d = v + needle_len - 1
    target = nblocks * v + needle_len - 1
    # Samples past the last block's reach cannot affect the lags.
    hay = (haystack[..., :target] if haystack.shape[-1] >= target
           else pad_to(haystack, target))
    rdtype = real_dtype_of(s_conj.dtype)
    dev = s_conj.device
    shape = s_conj.shape[:-2] + ((num_peaks,) if lattice else ())
    best = CafPeak(value=torch.full(shape, -math.inf, dtype=rdtype,
                                    device=dev),
                   freq_idx=torch.zeros(shape, dtype=torch.int32, device=dev),
                   lag_idx=torch.zeros(shape, dtype=torch.int32, device=dev))
    fsum = torch.zeros(s_conj.shape[:-2], dtype=rdtype, device=dev)
    fcnt = torch.zeros(s_conj.shape[:-2], dtype=rdtype, device=dev)
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
            fsum = fsum + torch.sum(torch.where(keep_b, rows, 0.0),
                                    dim=(-2, -1))
            fcnt = fcnt + torch.sum(keep_b.to(rdtype), dim=(-2, -1))
        if lattice:
            cand = find_peaks(torch.where(keep, rows, -math.inf), num_peaks,
                              exclude_freq, exclude_lag)
            cand = CafPeak(cand.value, cand.freq_idx, cand.lag_idx + b * v)
            best = merge_peaks(concat_peaks(best, cand), num_peaks,
                               exclude_freq, exclude_lag)
            continue
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
    freqs = signal_grid(freqs_hz, n)
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


def detection_rows(freqs_np, pk: CafPeak, floor, num_cells: int,
                   min_snr_db, with_snr: bool):
    """Lattice -> detections epilogue of every multi-peak endpoint:
    :func:`apply_detection_threshold` (slots below the SNR threshold mask
    to -inf) and the host ``(freqs, lags, values[, snr_db])`` output.
    ``pk`` fields may be (P,) or batched (..., P)."""
    vals, snr, _ = apply_detection_threshold(
        pk.value.cpu().numpy(), floor, num_cells, min_snr_db)
    out = (np.asarray(freqs_np)[pk.freq_idx.cpu().numpy()],
           pk.lag_idx.cpu().numpy(), vals)
    return out + ((snr,) if with_snr else ())


def _os_peaks(n: torch.Tensor, h: torch.Tensor, freqs_t: torch.Tensor,
              sample_rate: float, num_lags: int, num_peaks: int,
              exclude_freq: int, exclude_lag: int, with_floor: bool):
    """Lattice scan of (..., N) needles against (..., L) captures: fields
    (..., num_peaks) (``num_peaks == 1`` runs the single-peak loop and
    lifts it to a 1-slot lattice), plus the floor accumulators when
    ``with_floor``."""
    m, _, _ = plan_blocks(n.shape[-1], num_lags)
    s_conj = needle_spectra_conj(n, freqs_t, sample_rate, m)
    out = streaming_peak(s_conj, h, n.shape[-1], num_lags,
                         num_peaks=num_peaks, exclude_freq=exclude_freq,
                         exclude_lag=exclude_lag, with_floor=with_floor)
    if num_peaks > 1:
        return out
    if with_floor:
        return (as_lattice(out[0]),) + tuple(out[1:])
    return as_lattice(out)


def _lattice_rows(n, h, freqs, freqs_t, sample_rate, needle0, num_peaks,
                  num_lags, exclude_freq, exclude_lag, min_snr_db,
                  with_snr):
    """The shared body of the lattice endpoints below."""
    lags = num_lags or h.shape[-1] - n.shape[-1] + 1
    exclude_freq, exclude_lag = resolve_exclusions(
        needle0, freqs, sample_rate, exclude_freq, exclude_lag)
    want_floor = with_snr or min_snr_db is not None
    out = _os_peaks(n, h, freqs_t, float(sample_rate), lags,
                    int(num_peaks), exclude_freq, exclude_lag, want_floor)
    if not want_floor:
        return (freqs[out.freq_idx.cpu().numpy()],
                out.lag_idx.cpu().numpy(), out.value.cpu().numpy())
    pk, fsum, fcnt = out
    return detection_rows(freqs, pk, mean_floor(fsum, fcnt),
                          lags * freqs.shape[0], min_snr_db, with_snr)


def overlap_save_peaks(needle, haystack, freqs_hz, sample_rate,
                       num_peaks: int, num_lags: Optional[int] = None, *,
                       exclude_freq: Optional[int] = None,
                       exclude_lag: Optional[int] = None,
                       backend: Optional[str] = None, min_snr_db=None,
                       with_snr: bool = False, device=None):
    """Top-``num_peaks`` emitters of a long capture, strongest first:
    ``(freqs_hz (P,), lags (P,), values (P,)[, snr_db (P,)])`` numpy
    arrays, slots past the distinct detections ``-inf``.

    The block loop carries an NMS lattice, so the full surface never
    materializes and emitters straddling block edges deduplicate.
    Exclusion windows default to the waveform's resolution cell.
    ``min_snr_db`` (a float, or ``"auto"`` for
    :func:`detection_threshold_db` at the searched cell count) masks
    slots whose peak-to-floor dB falls below it; the floor is the mean
    mag^2 over every searched cell, accumulated in the same loop.
    ``with_snr=True`` appends per-slot peak-to-floor dB."""
    resolve_backend(backend)
    n, h, freqs, freqs_t = _prep(needle, haystack, freqs_hz, device)
    return _lattice_rows(n, h, freqs, freqs_t, sample_rate, n, num_peaks,
                         num_lags, exclude_freq, exclude_lag, min_snr_db,
                         with_snr)


def batched_overlap_save_peaks_local(needles, haystacks, freqs_hz,
                                     sample_rate, num_peaks: int,
                                     num_lags: Optional[int] = None, *,
                                     exclude_freq: Optional[int] = None,
                                     exclude_lag: Optional[int] = None,
                                     backend: Optional[str] = None,
                                     min_snr_db=None, with_snr: bool = False,
                                     device=None):
    """Top-``num_peaks`` emitters PER PAIR on one device: (B, N) needles
    x (B, L) captures -> ``(freqs (B, P), lags (B, P), values (B, P)[,
    snr_db (B, P)])``, strongest first per pair.  The pairs ride a
    leading axis of one lattice loop; exclusion windows default to the
    first needle's resolution cell, and each pair is thresholded
    against its own measured floor (see :func:`overlap_save_peaks`)."""
    resolve_backend(backend)
    n = as_signal(needles, device)
    h = as_signal(haystacks, n.device).to(n.dtype)
    if n.ndim != 2 or h.ndim != 2 or n.shape[0] != h.shape[0]:
        raise ValueError(
            f"need (B, N) needles and (B, L) haystacks, got "
            f"{tuple(n.shape)} vs {tuple(h.shape)}")
    if h.shape[-1] < n.shape[-1]:
        raise ValueError("haystacks shorter than needles")
    freqs = signal_grid(freqs_hz, n)
    return _lattice_rows(n, h, freqs, torch.from_numpy(freqs).to(n.device),
                         sample_rate, n[0], num_peaks, num_lags,
                         exclude_freq, exclude_lag, min_snr_db, with_snr)
