"""Batched Stein engines — one fused coarse rank for a batch of pairs,
of bands or of overlap-save windows (``bench_configs.py`` configs 2-4).

Stage A of the kernel computes the segment correlations
``G[b, tau] = sum_d conj(n[bD+d]) * h[bD+d+tau]`` as a dense
(2B, 2D) x (2D, span) product of a needle-tap operator and Hankel rows
of a haystack extension; :func:`_needle_operator`,
:func:`_haystack_extension` and :func:`_os_window_extensions` build the
two operands in the JAX package's layout.  The kernel's program axis
then carries:

* :func:`batched_stein_peak` — one program per pair of a (P, N) batch
  (K1 mode (b));
* the banded engines — wide-span uniform grids split into bands, the
  needle shifted to each band centre, one program per (pair, band)
  sharing the pair's haystack (K1 mode (c), ``share_h``);
* :func:`batched_stein_os_peak` — long captures: one program per
  (pair[, band], overlap-save window), each bounded by its own lag
  count (K1 mode (d), ``windows`` + ``num_valid``).

The coarse rank only ranks bins: the top candidates of each pair are
re-scored with exact filterbank rows (the rank-then-score contract of
every Stein engine).  On CUDA tensors the rank launches the kernel; on
CPU tensors it runs the kernel's plain version in f32, as the JAX
package's CPU route runs its XLA twin ``_coarse_rank_xla``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (as_grid, floor_pow2,
                                          resolve_backend, xcor_length)
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models.filterbank import _surface_rows, mag2
from caf_cookoff_tpu_torch.ops.fused_stein import (FUSED_TILE, SUPER,
                                                   coarse_rank_plain,
                                                   fused_span,
                                                   fused_stein_rank,
                                                   stein_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import CafPeak
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal


def _pow2_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Largest power-of-two block length within the sinc-envelope limit
    (:func:`caf_cookoff_tpu_torch.models.stein._auto_block_len`), capped
    at ``SUPER`` so SUPER-padded needles split into whole blocks."""
    from caf_cookoff_tpu_torch.models.stein import _auto_block_len

    d = floor_pow2(min(_auto_block_len(sample_rate, freqs_hz, requested),
                       SUPER))
    if d < 8:
        raise SpanError("block length below 8 after pow2 rounding")
    return d


def _needle_operator(ns_re: torch.Tensor, ns_im: torch.Tensor, d: int):
    """(P, 2B, 2*D) dense needle-tap operator for stage A.

    Rows [0, B) produce Re(G), rows [B, 2B) Im(G); columns [0, D) act on
    the haystack's real plane, [D, 2*D) on its imaginary plane.  Needles
    must already be padded to whole blocks.  Returns ``(lmat, D)``.
    """
    p, n_pad = ns_re.shape
    b = n_pad // d
    tr = ns_re.reshape(p, b, d)              # Re(conj n) = nr
    ti = (-ns_im).reshape(p, b, d)           # Im(conj n) = -ni
    # G = sum conj(n)*h: Gr = tr.hr + (-ti).hi;  Gi = ti.hr + tr.hi.
    top = torch.cat([tr, -ti], dim=2)
    bot = torch.cat([ti, tr], dim=2)
    return torch.cat([top, bot], dim=1), d


def _haystack_extension(hs_re: torch.Tensor, hs_im: torch.Tensor, m: int,
                        span: int) -> torch.Tensor:
    """(P, 2, span+SUPER-1) circularly extended haystack planes: the
    M-point correlation indexes h mod M (zeros in [N, M)), so the
    extension tiles the zero-padded period."""
    p, n_h = hs_re.shape
    need = span + SUPER - 1
    reps = -(-need // m)

    def circ(hp):
        base = torch.cat([hp, hp.new_zeros(p, m - n_h)], dim=-1)
        return base.repeat(1, reps)[:, :need]

    return torch.stack([circ(hs_re), circ(hs_im)], dim=1)


def _os_window_extensions(hs_re: torch.Tensor, hs_im: torch.Tensor, v: int,
                          windows: int, span: int) -> torch.Tensor:
    """(P*W, 2, span+SUPER-1) linear (not circular) per-window slices:
    window ``w`` of a pair covers lags [w*V, w*V + V) and reads the raw
    capture from sample ``w*V`` (overlap-save's implicit halo),
    zero-padded past the capture's end so trailing lags score 0."""
    p = hs_re.shape[0]
    win_len = span + SUPER - 1
    need = (windows - 1) * v + win_len
    hs_re, hs_im = (pad_to(x, max(need, x.shape[-1])) for x in (hs_re, hs_im))
    slices = [torch.stack([hs_re[:, w * v:w * v + win_len],
                           hs_im[:, w * v:w * v + win_len]], dim=1)
              for w in range(windows)]                # each (P, 2, L)
    return torch.stack(slices, dim=1).reshape(p * windows, 2, win_len)


def _shift_to_centers(ns_re: torch.Tensor, ns_im: torch.Tensor,
                      centers: torch.Tensor, sample_rate: float):
    """(P*S, N_pad) needle planes shifted to every band centre (exact:
    shifts compose), padded to whole SUPER tiles, band-major.  The phase
    is ``((2*pi)/fs) * c * t`` in f32, in the JAX package's order."""
    p, n = ns_re.shape
    s = centers.shape[0]
    dt = ns_re.dtype
    t = torch.arange(n, dtype=dt, device=ns_re.device)
    scale = (torch.tensor(2.0 * math.pi, dtype=dt, device=ns_re.device)
             / torch.tensor(sample_rate, dtype=dt, device=ns_re.device))
    ph = (scale * centers.to(dt)[None, :, None]) * t[None, None, :]
    cs, sn = torch.cos(ph), torch.sin(ph)
    sr = (ns_re[:, None, :] * cs - ns_im[:, None, :] * sn).reshape(p * s, n)
    si = (ns_re[:, None, :] * sn + ns_im[:, None, :] * cs).reshape(p * s, n)
    n_pad = n + (-n) % SUPER
    return pad_to(sr, n_pad), pad_to(si, n_pad)


def _coarse_rank(ws1, ws2, lmat, h_ext, b: int, sup: int, num_lags: int,
                 want_idxs: bool = True, windows: int = 1, share_h: int = 1,
                 num_valid=None):
    """((K, P_eff) values, lags) of the coarse rank: the kernel for CUDA
    tensors, the f32 plain version for CPU tensors (the JAX package's
    CPU route)."""
    lmat, h_ext = lmat.float(), h_ext.float()
    if lmat.device.type == "cpu":
        return coarse_rank_plain(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                                 windows=windows, share_h=share_h,
                                 num_valid=num_valid)
    return fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                            want_idxs=want_idxs, windows=windows,
                            share_h=share_h, num_valid=num_valid)


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


def _batched_refine(ns, hs, freqs_all, vals_t, sample_rate, xcor_len: int,
                    num_valid: Optional[int] = None) -> CafPeak:
    """Per-pair exact re-score of a (P, K) coarse ranking, shared by the
    plain and banded batch paths: 12 candidates per pair (the hybrid
    plain / mainlobe-separated set); ``num_valid`` caps the plain picks
    so -inf padded bins never enter the re-score."""
    from caf_cookoff_tpu_torch.models.stein import _refine_candidates

    cand = _refine_candidates(vals_t, freqs_all, ns.shape[-1], sample_rate,
                              num_valid)                    # (P, r)
    exact = mag2(_surface_rows(ns, hs, freqs_all[cand.long()], sample_rate,
                               xcor_len))                   # (P, r, M)
    return _pick(torch.amax(exact, dim=-1), cand, torch.argmax(exact, dim=-1))


def _batch_operands(ns, hs, freqs_t, sample_rate, xcor_len: int,
                    block_len: int):
    """K1's operands for an equal-length batch (needles SUPER-padded):
    ``((ws1, ws2, lmat, h_ext), b, sup, modes)``, one program per pair."""
    b = ns.shape[-1] // block_len
    lmat, sup = _needle_operator(ns.real, ns.imag, block_len)
    h_ext = _haystack_extension(hs.real, hs.imag, xcor_len,
                                fused_span(b, sup, xcor_len))
    ws1, ws2 = stein_synthesis_weights(freqs_t, sample_rate, b, block_len)
    return (ws1, ws2, lmat, h_ext), b, sup, {}


def _batched_stein_core(ns, hs, freqs_t, sample_rate, xcor_len: int,
                        block_len: int, refine: bool) -> CafPeak:
    """Equal-length batch (needles SUPER-padded): one program per pair,
    then the exact re-score (or, ``refine=False``, the coarse answer)."""
    ops, b, sup, _ = _batch_operands(ns, hs, freqs_t, sample_rate,
                                     xcor_len, block_len)
    vals, idxs = _coarse_rank(*ops, b, sup, xcor_len,
                              want_idxs=not refine)          # (K, P)
    vals_t = vals.T                                          # (P, K)
    if not refine:
        best = torch.argmax(vals_t, dim=1, keepdim=True)     # (P, 1)
        return CafPeak(value=torch.gather(vals_t, 1, best)[:, 0],
                       freq_idx=best[:, 0].to(torch.int32),
                       lag_idx=torch.gather(idxs.T, 1, best)[:, 0])
    return _batched_refine(ns, hs, freqs_t, vals_t, sample_rate, xcor_len)


def _banded_operands(ns, hs, centers, rel, sample_rate, xcor_len: int,
                     block_len: int):
    """K1's operands for a banded batch: one needle operator per (pair,
    band), the needle shifted to the band centre, and one haystack
    extension per pair that the pair's bands share (``share_h``)."""
    sr, si = _shift_to_centers(ns.real, ns.imag, centers, sample_rate)
    b = sr.shape[-1] // block_len
    lmat, sup = _needle_operator(sr, si, block_len)
    h_ext = _haystack_extension(hs.real, hs.imag, xcor_len,
                                fused_span(b, sup, xcor_len))
    ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b, block_len)
    return (ws1, ws2, lmat, h_ext), b, sup, {"share_h": centers.shape[0]}


def _banded_batched(ns, hs, freqs_pad, centers, rel, sample_rate,
                    xcor_len: int, block_len: int, num_bins: int) -> CafPeak:
    """Wide-span batch: one program per (pair, band); the exact re-score
    runs on absolute frequencies with the unshifted needles.  Flat bin =
    ``band*Kb + j`` on ``freqs_pad``'s ascending lattice."""
    p, s = ns.shape[0], centers.shape[0]
    ops, b, sup, modes = _banded_operands(ns, hs, centers, rel, sample_rate,
                                          xcor_len, block_len)
    vals, _ = _coarse_rank(*ops, b, sup, xcor_len, want_idxs=False,
                           **modes)                          # (Kb, P*S)
    kb = rel.shape[0]
    flat = vals.T.reshape(p, s * kb)
    flat = torch.where(torch.arange(s * kb, device=flat.device)[None, :]
                       < num_bins, flat, -math.inf)
    return _batched_refine(ns, hs, freqs_pad, flat, sample_rate, xcor_len,
                           num_valid=num_bins)


def _os_topk_refine(ns, hs, freqs_all, rowmax, rowlag, sample_rate,
                    xcor_len: int, total_lags: int, needle_len: int,
                    num_valid_bins: Optional[int] = None) -> CafPeak:
    """Windowed-coarse closer: per pair, the top candidates of a (P, K)
    ranking whose per-bin best lags are ``rowlag`` are re-scored exactly
    on a guard-extended capture slice at the pair's coarse winning lag.

    The slice is based on the original needle length (``ns`` may carry
    SUPER padding): the winning local lag (~``guard``) then correlates
    every needle sample against real data.  Only local lags with full
    correlation energy, and absolute lags inside the requested range,
    may win."""
    from caf_cookoff_tpu_torch.models.stein import _refine_candidates

    cand = _refine_candidates(rowmax, freqs_all, needle_len, sample_rate,
                              num_valid_bins)                # (P, r)
    best_bin = torch.argmax(rowmax, dim=-1, keepdim=True)
    best_lag = torch.gather(rowlag, 1, best_bin)[:, 0]       # (P,)
    n, hay_len = needle_len, hs.shape[-1]
    guard = min(64, n // 4, max((hay_len - n) // 2, 0))
    win = n + 2 * guard
    start = torch.clamp(best_lag.long() - guard, 0, max(hay_len - win, 0))
    dev = hs.device
    slices = torch.gather(hs, 1, start[:, None]
                          + torch.arange(win, device=dev)[None, :])
    exact = mag2(_surface_rows(ns, slices, freqs_all[cand.long()],
                               sample_rate, xcor_len))      # (P, r, M)
    local = torch.arange(xcor_len, device=dev)
    ok = (local <= 2 * guard)[None, :] & (start[:, None] + local < total_lags)
    exact = torch.where(ok[:, None, :], exact, -1.0)
    pk = _pick(torch.amax(exact, dim=-1), cand, torch.argmax(exact, dim=-1))
    return CafPeak(pk.value, pk.freq_idx,
                   (start + pk.lag_idx).to(torch.int32))


def _os_operands(ns, hs, centers, rel, sample_rate, v: int,
                 block_len: int, windows: int, total_lags: int):
    """K1's operands for a long-capture batch: one haystack slice per
    (pair, overlap-save window) and a per-program lag bound; with band
    ``centers`` one needle operator per (pair, band) (the needles shifted
    to the centres, ``rel`` the relative grid), else one per pair (the
    needles SUPER-padded, ``rel`` the grid)."""
    p = ns.shape[0]
    if centers is None:
        sr, si, s = ns.real, ns.imag, 1
    else:
        sr, si = _shift_to_centers(ns.real, ns.imag, centers, sample_rate)
        s = centers.shape[0]
    b = sr.shape[-1] // block_len
    lmat, sup = _needle_operator(sr, si, block_len)
    h_ext = _os_window_extensions(hs.real, hs.imag, v, windows,
                                  fused_span(b, sup, v))
    ws1, ws2 = stein_synthesis_weights(rel, sample_rate, b, block_len)
    # The last window's range may end mid-window, and real capture
    # samples past it must not shadow in-range peaks inside the per-bin
    # max: each program is bounded by clip(total - w*V, 0, V).
    per_w = np.clip(total_lags - np.arange(windows) * v, 0, v)
    num_valid = torch.as_tensor(np.tile(per_w, p * s), dtype=torch.int32,
                                device=ns.device)
    return (ws1, ws2, lmat, h_ext), b, sup, {
        "windows": windows, "share_h": s, "num_valid": num_valid}


def _best_window(vals, idxs, v: int, total_lags: int):
    """Per (bin, ...) the best window of (..., W) window-local results:
    (value, global lag), the earliest window on ties."""
    windows = vals.shape[-1]
    glob = idxs + torch.arange(windows, dtype=torch.int32,
                               device=idxs.device) * v
    vals = torch.where(glob < total_lags, vals, -1.0)
    wbest = torch.argmax(vals, dim=-1, keepdim=True)
    return (torch.gather(vals, -1, wbest)[..., 0],
            torch.gather(glob, -1, wbest)[..., 0])


def _stein_os(ns, hs, freqs_all, centers, rel, sample_rate, xcor_len: int,
              block_len: int, windows: int, total_lags: int,
              needle_len: int, num_bins: Optional[int] = None) -> CafPeak:
    """Windowed long-capture scan, one program per (pair[, band],
    window), then the guard-extended exact re-score (absolute
    frequencies, unshifted needles).  Banded (``centers`` given): global
    bin = ``band*Kb + j`` on ``freqs_all``'s ascending lattice, -inf
    past ``num_bins``."""
    p, v = ns.shape[0], xcor_len
    ops, b, sup, modes = _os_operands(ns, hs, centers, rel, sample_rate, v,
                                      block_len, windows, total_lags)
    vals, idxs = _coarse_rank(*ops, b, sup, v, **modes)
    kb, s = rel.shape[0], modes["share_h"]
    rowmax, rowlag = _best_window(vals.reshape(kb, p, s, windows),
                                  idxs.reshape(kb, p, s, windows), v,
                                  total_lags)               # (Kb, P, S)
    rowmax = rowmax.permute(1, 2, 0).reshape(p, s * kb)
    rowlag = rowlag.permute(1, 2, 0).reshape(p, s * kb)
    if num_bins is not None:
        rowmax = torch.where(torch.arange(s * kb, device=rowmax.device)
                             < num_bins, rowmax, -math.inf)
    return _os_topk_refine(ns, hs, freqs_all, rowmax, rowlag, sample_rate,
                           xcor_len, total_lags, needle_len,
                           num_valid_bins=num_bins)


def _batch(needles, haystacks, device):
    ns = as_signal(needles, device)
    hs = as_signal(haystacks, ns.device).to(ns.dtype)
    rdtype = np.float64 if ns.dtype == torch.complex128 else np.float32
    return ns, hs, rdtype


def _host(freqs: np.ndarray, peak: CafPeak):
    """(freqs (P,), lags (P,), values (P,)) numpy arrays of a batch."""
    return (freqs[peak.freq_idx.cpu().numpy()], peak.lag_idx.cpu().numpy(),
            peak.value.cpu().numpy())


def _as_tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def batched_stein_os_peak(needles, haystacks, freqs_hz, sample_rate, *,
                          num_lags: Optional[int] = None,
                          block_len: int = 64,
                          backend: Optional[str] = None, device=None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Long-capture per-pair peaks: (freqs (P,), lags (P,), values (P,)).

    Config 3/4's workload: each pair's lag axis splits into M-lag
    overlap-save windows and every (pair[, band], window) runs as one
    program of the fused kernel.  The coarse ranking is window-global;
    the exact top-k re-score runs on a guard-extended slice at the
    coarse winning lag.  Uniform grids route through the banded windowed
    engine whenever the band plan's modelled cost wins
    (:func:`caf_cookoff_tpu_torch.models.stein._band_routing`), which
    covers spans the single-band envelope cannot take at all.  Every FFT
    ``backend`` name runs ``torch.fft``.
    """
    from caf_cookoff_tpu_torch.models.stein import _band_routing

    resolve_backend(backend)
    ns, hs, rdtype = _batch(needles, haystacks, device)
    if ns.ndim != 2 or hs.ndim != 2 or ns.shape[0] != hs.shape[0]:
        raise ValueError(
            f"need (P, N) needles and (P, L) haystacks, got "
            f"{tuple(ns.shape)} vs {tuple(hs.shape)}")
    n = ns.shape[-1]
    if hs.shape[-1] <= n:
        raise ValueError("use batched_stein_peak for equal-length pairs")
    freqs = as_grid(freqs_hz, dtype=rdtype)
    fs = float(sample_rate)
    try:
        d = _pow2_block_len(fs, freqs, block_len)
    except SpanError:
        d = None                     # span needs banding (or raises below)
    use_banded, d, freqs_pad, centers, rel = _band_routing(fs, freqs, d)
    if d is None:
        _pow2_block_len(fs, freqs, block_len)   # re-raise
    m = xcor_length(n)
    total_lags = num_lags or hs.shape[-1] - n + 1
    windows = -(-total_lags // m)
    dev = ns.device
    if use_banded:
        peak = _stein_os(ns, hs, _as_tensor(freqs_pad, dev),
                         _as_tensor(centers, dev), _as_tensor(rel, dev), fs,
                         m, d, windows, total_lags, n, len(freqs))
        return _host(freqs_pad, peak)
    freqs_t = _as_tensor(freqs, dev)
    peak = _stein_os(pad_to(ns, n + (-n) % SUPER), hs, freqs_t, None,
                     freqs_t, fs, m, d, windows, total_lags, n)
    return _host(freqs, peak)


def batched_stein_peak(needles, haystacks, freqs_hz, sample_rate, *,
                       block_len: int = 64, refine: bool = True,
                       backend: Optional[str] = None, device=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair peaks for a (P, N) batch: (freqs (P,), lags (P,), values).

    Config 2's path: one coarse-rank launch for the whole batch, then
    one batched exact re-score — the same answers as
    :func:`caf_cookoff_tpu_torch.models.stein.stein_caf_peak` per pair.
    Grids past the single-segment envelope are banded, (pair, band) as
    the kernel's program axis.  Every FFT ``backend`` name runs
    ``torch.fft``.
    """
    from caf_cookoff_tpu_torch.models.stein import _plan_bands

    resolve_backend(backend)
    ns, hs, rdtype = _batch(needles, haystacks, device)
    if ns.ndim != 2 or hs.shape != ns.shape:
        raise ValueError(
            f"need matching (P, N) batches, got {tuple(ns.shape)} vs "
            f"{tuple(hs.shape)}")
    freqs = as_grid(freqs_hz, dtype=rdtype)
    fs = float(sample_rate)
    n = ns.shape[-1]
    m = xcor_length(n)
    if m % FUSED_TILE:
        raise EligibilityError(
            f"xcor length {m} not a multiple of {FUSED_TILE}")
    dev = ns.device
    try:
        d = _pow2_block_len(fs, freqs, block_len)
    except SpanError:
        # Wide-span batch: band the grid, (pair, band) as the programs.
        plan = _plan_bands(fs, freqs) if refine else None
        if plan is None:
            raise
        peak = _banded_batched(
            ns, hs, _as_tensor(plan["freqs_pad"], dev),
            _as_tensor(plan["centers"], dev), _as_tensor(plan["rel"], dev),
            fs, m, plan["block_len"], len(freqs))
        return _host(plan["freqs_pad"], peak)
    # Pad the needle to whole super-blocks (appended zero blocks add
    # nothing to any correlation); the haystack and M are untouched.
    peak = _batched_stein_core(pad_to(ns, n + (-n) % SUPER), hs,
                               _as_tensor(freqs, dev), fs, m, d, refine)
    return _host(freqs, peak)
