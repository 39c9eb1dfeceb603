"""The Stein engines' exact re-score: K5's wrapper and its plain version.

Every Stein engine ranks bins coarsely, then re-scores the top
candidates of each pair with exact filterbank rows (the rank-then-score
contract).  From a (P, K) coarse ranking (or one (K,) ranking and one
pair), per pair:

* the candidates (:func:`_refine_candidates`): the plain top 8 (equal
  values lowest bin first, as ``jax.lax.top_k``; at most ``num_valid``
  when -inf pads the ranking), then the top 4 separated by the doppler
  mainlobe (``ops/peak.topk_separated``);
* each candidate's exact row ``|IDFT(H conj(DFT(shifted needle)))|^2 /
  M^2`` and its (max, lowest lag), over the lags up to the pair's
  ``lag_bound`` when one is given;
* the highest value, exact ties to the lowest bin, then the first slot
  (:func:`_pick`).

:func:`stein_rescore` routes by device: CPU tensors run
:func:`rescore_plain`, the torch chain; tensors on a card launch
``csrc/stein_rescore.cu`` (three launches: candidates, rows, pick; a
failed build or launch raises) and nothing else.  There K5 takes
complex64 signals and a power-of-two correlation length ``32 <= M <=
MAX_FFT_LEN`` (the range of K2's block transform); :func:`check_card`
refuses anything else before a launch, as K2's wrapper does.
``RESCORE_LAUNCHES`` counts K5's calls; a call captured into a CUDA
graph counts at each replay (``ops/_graph``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError
from caf_cookoff_tpu_torch.ops.pallas_caf import (MAX_FFT_LEN, _h_kernel,
                                                  _twiddles, cluster_size)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, doppler_cell_bins,
                                            topk_separated)

# Candidates of the exact re-score: _REFINE_BINS plain top-k picks
# (adjacent near-tie flips) plus _REFINE_SEP_BINS mainlobe-separated
# picks (distinct lobes on grids finer than the fs/N mainlobe).
_REFINE_BINS = 8
_REFINE_SEP_BINS = 4
MIN_FFT_LEN = 32    # the shortest row K2's block transform holds

RESCORE_LAUNCHES = 0


class Rescored(NamedTuple):
    """One K5 call: the answer, and per (pair, slot) the candidate bins
    and their rows' (value, lag)."""
    peak: CafPeak
    cand: torch.Tensor     # (P, slots) int32
    vals: torch.Tensor     # (P, slots) f32
    lags: torch.Tensor     # (P, slots) int32


def _num_picks(k: int, num_valid: Optional[int]):
    """(plain, separated) picks of a K-bin ranking."""
    plain = min(_REFINE_BINS, k, num_valid or _REFINE_BINS)
    return plain, min(_REFINE_SEP_BINS, plain)


def _refine_candidates(rowmax_coarse: torch.Tensor, freqs_all: torch.Tensor,
                       needle_len: int, sample_rate,
                       num_valid: Optional[int] = None) -> torch.Tensor:
    """Candidate bins of the exact re-score for a (K,) ranking, or each
    row of a (P, K) one: the plain top-k (equal values lowest bin first,
    as ``jax.lax.top_k``) followed by a mainlobe-separated top-k.
    ``num_valid`` caps the plain picks when the ranking carries -inf
    padded bins (banded grids).  Duplicates are harmless."""
    k, ksep = _num_picks(int(rowmax_coarse.shape[-1]), num_valid)
    cand = torch.sort(rowmax_coarse, dim=-1, descending=True,
                      stable=True).indices[..., :k].to(torch.int32)
    sep = doppler_cell_bins(freqs_all, needle_len, sample_rate)
    cand_sep = topk_separated(rowmax_coarse, ksep, sep)
    return torch.cat([cand, cand_sep], dim=-1)


def _pick(rowmax: torch.Tensor, cand: torch.Tensor,
          lags: torch.Tensor) -> CafPeak:
    """Per pair, the candidate with the highest exact value; exact ties
    go to the lowest bin, then the first slot (the JAX package's
    ``lexsort((cand, -rowmax))[0]``)."""
    top = rowmax == torch.amax(rowmax, dim=-1, keepdim=True)
    winner = torch.amin(torch.where(top, cand, torch.iinfo(torch.int32).max),
                        dim=-1, keepdim=True)
    best = torch.argmax((top & (cand == winner)).to(torch.int8), dim=-1,
                        keepdim=True)
    take = lambda a: torch.gather(a, -1, best)[..., 0]  # noqa: E731
    return CafPeak(value=take(rowmax), freq_idx=take(cand).to(torch.int32),
                   lag_idx=take(lags).to(torch.int32))


def rescore_plain(needles, haystacks, freqs, ranking, sample_rate,
                  xcor_len: int, needle_len: int,
                  num_valid: Optional[int] = None,
                  lag_bound: Optional[torch.Tensor] = None) -> CafPeak:
    """The re-score in torch and ``torch.fft``, the CPU's (and, on a
    card, the reference the card tests hold K5 to): needles (..., N),
    haystacks (..., L <= M), ranking (..., K) on the grid ``freqs``;
    ``lag_bound`` (P,) masks each pair's lags past it to -1."""
    from caf_cookoff_tpu_torch.models.filterbank import _surface_rows, mag2

    cand = _refine_candidates(ranking, freqs, needle_len, sample_rate,
                              num_valid)
    exact = mag2(_surface_rows(needles, haystacks, freqs[cand.long()],
                               sample_rate, xcor_len))       # (..., r, M)
    if lag_bound is not None:
        local = torch.arange(xcor_len, device=exact.device)
        ok = local[None, :] <= lag_bound[:, None]
        exact = torch.where(ok[:, None, :], exact, -1.0)
    return _pick(torch.amax(exact, dim=-1), cand, torch.argmax(exact, dim=-1))


def check_card(dtype: torch.dtype, m: int) -> None:
    """K5's range, the card's only re-score: complex64 signals
    (``EligibilityError`` otherwise; ``device="cpu"`` re-scores
    complex128) and a power of two ``32 <= M <= MAX_FFT_LEN``
    (``VmemBudgetError`` past it, as K2; ``EligibilityError`` below it or
    off a power of two)."""
    if dtype != torch.complex64:
        raise EligibilityError(
            f"Stein re-score kernel: takes complex64 signals on the card, "
            f"got {dtype}; pass complex64, or device='cpu' for {dtype}")
    if m > MAX_FFT_LEN:
        raise VmemBudgetError(
            f"Stein re-score kernel: a {m}-point complex64 row does not "
            f"fit the shared memory of a cluster of blocks (M <= "
            f"{MAX_FFT_LEN})")
    if m < MIN_FFT_LEN or m & (m - 1):
        raise EligibilityError(
            f"Stein re-score kernel: M = {m} is not a power of two in "
            f"[{MIN_FFT_LEN}, {MAX_FFT_LEN}]")


def stein_rescore(needles, haystacks, freqs, ranking, sample_rate,
                  xcor_len: int, needle_len: int,
                  num_valid: Optional[int] = None,
                  lag_bound: Optional[torch.Tensor] = None) -> CafPeak:
    """The exact re-score of a coarse ranking: :class:`CafPeak` fields
    (P,) for needles (P, N), haystacks (P, L <= M) and a ranking (P, K),
    0-d for a (N,) needle, a (L,) haystack and a (K,) ranking.
    ``needle_len`` sizes the doppler mainlobe of the separated picks,
    ``num_valid`` caps the plain picks, ``lag_bound`` (P,) bounds each
    pair's lags (inclusive).  :func:`rescore_plain` on the CPU, K5
    anywhere else (:func:`check_card`)."""
    if needles.shape[-1] > xcor_len or haystacks.shape[-1] > xcor_len:
        raise ValueError(f"needle {needles.shape[-1]} / haystack "
                         f"{haystacks.shape[-1]} longer than M = {xcor_len}")
    if needles.device.type == "cpu":
        return rescore_plain(needles, haystacks, freqs, ranking,
                             sample_rate, xcor_len, needle_len, num_valid,
                             lag_bound)
    check_card(needles.dtype, xcor_len)
    if needles.ndim == 1:
        pk = rescore_kernel(needles[None], haystacks[None], freqs,
                            ranking[None], sample_rate, xcor_len, needle_len,
                            num_valid, lag_bound).peak
        return CafPeak(*(x[0] for x in pk))
    return rescore_kernel(needles, haystacks, freqs, ranking, sample_rate,
                          xcor_len, needle_len, num_valid, lag_bound).peak


def rescore_kernel(needles, haystacks, freqs, ranking, sample_rate, m: int,
                   needle_len: int, num_valid: Optional[int] = None,
                   lag_bound: Optional[torch.Tensor] = None) -> Rescored:
    """K5 on CUDA (P, N) needles: the pairs' spectra by ``torch.fft`` in
    K2's order, then one counted call of three launches."""
    global RESCORE_LAUNCHES
    from caf_cookoff_tpu_torch.ops import _build

    if ranking.dtype != torch.float32 or freqs.dtype != torch.float32:
        raise TypeError(f"K5 takes an f32 ranking and grid with complex64 "
                        f"signals, got {ranking.dtype} and {freqs.dtype}")
    dev = needles.device
    p, k = ranking.shape
    if (needles.ndim != 2 or needles.shape[0] != p
            or haystacks.shape[0] != p
            or (lag_bound is not None and lag_bound.shape != (p,))):
        raise ValueError(f"needles {tuple(needles.shape)}, haystacks "
                         f"{tuple(haystacks.shape)} and lag bounds for a "
                         f"ranking of {p} pairs")
    if any(t.device != dev for t in (haystacks, freqs, ranking, lag_bound)
           if t is not None):
        raise ValueError(f"K5's tensors must all be on {dev}")
    n_plain, n_sep = _num_picks(k, num_valid)
    slots = n_plain + n_sep
    c = cluster_size(m)
    f32 = np.float32
    needles = needles.contiguous()
    ranking, freqs = ranking.contiguous(), freqs.contiguous()
    bounds = (None if lag_bound is None
              else lag_bound.to(torch.int32).contiguous())
    h_k = _h_kernel(torch.fft.fft(haystacks.to(torch.complex64), n=m,
                                  dim=-1), m, c).contiguous()
    cand = torch.empty((p, slots), dtype=torch.int32, device=dev)
    lags = torch.empty_like(cand)
    vals = torch.empty((p, slots), dtype=torch.float32, device=dev)
    value = torch.empty(p, dtype=torch.float32, device=dev)
    freq_idx = torch.empty(p, dtype=torch.int32, device=dev)
    lag_idx = torch.empty_like(freq_idx)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.caf_stein_rescore(
            ranking.data_ptr(), k, n_plain, n_sep, freqs.data_ptr(),
            freqs.shape[-1], float(f32(sample_rate) / f32(needle_len)),
            float(f32(2.0 * math.pi)), float(f32(sample_rate)),
            needles.data_ptr(), needles.shape[-1], h_k.data_ptr(),
            _twiddles(m // c, dev).data_ptr(),
            None if bounds is None else bounds.data_ptr(), p, m, c,
            cand.data_ptr(), vals.data_ptr(), lags.data_ptr(),
            value.data_ptr(), freq_idx.data_ptr(), lag_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Stein re-score kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    RESCORE_LAUNCHES += 1
    return Rescored(CafPeak(value=value, freq_idx=freq_idx, lag_idx=lag_idx),
                    cand, vals, lags)
