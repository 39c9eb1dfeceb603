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
  count (K1 mode (d), ``windows`` + ``num_valid``);
* the multi-emitter lattices :func:`batched_stein_peaks` (equal-length
  pairs, circular lags) and :func:`batched_stein_os_peaks` (long
  captures, banded or not): the same programs with K1's top-2 mode (e),
  two lag candidates per bin more than ``exclude_lag`` apart, folded
  into per-pair NMS lattices whose entries are then re-scored exactly.

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

from caf_cookoff_tpu_torch.config import (resolve_backend, signal_grid,
                                          xcor_length)
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models._stein_plan import (
    _as_tensor, _band_tensors, _compiled_call, _equal_batch, _grid_on, _host,
    _long_batch, _pack, _plan_bands, _pow2_block_len, _windowed_route)
from caf_cookoff_tpu_torch.models.overlap_save import detection_rows
from caf_cookoff_tpu_torch.ops.fused_stein import (FUSED_TILE, SUPER,
                                                   coarse_rank_plain,
                                                   fused_span,
                                                   fused_stein_rank,
                                                   stein_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, _lag_distance,
                                            find_peak_2d, merge_peaks,
                                            resolve_exclusions)
from caf_cookoff_tpu_torch.ops.shift import numpy_real
from caf_cookoff_tpu_torch.ops.stein_rescore import (_REFINE_BINS,
                                                     stein_rescore)
from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2, pad_to


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
    is ``((2*pi)/fs) * c * t`` in the planes' dtype, in the JAX
    package's order (the quotient of the rounded operands, in numpy)."""
    p, n = ns_re.shape
    s = centers.shape[0]
    dt = ns_re.dtype
    np_dt = numpy_real(dt)
    t = torch.arange(n, dtype=dt, device=ns_re.device)
    scale = float(np_dt(2.0 * math.pi) / np_dt(sample_rate))
    ph = (scale * centers.to(dt)[None, :, None]) * t[None, None, :]
    cs, sn = torch.cos(ph), torch.sin(ph)
    sr = (ns_re[:, None, :] * cs - ns_im[:, None, :] * sn).reshape(p * s, n)
    si = (ns_re[:, None, :] * sn + ns_im[:, None, :] * cs).reshape(p * s, n)
    n_pad = n + (-n) % SUPER
    return pad_to(sr, n_pad), pad_to(si, n_pad)


def _coarse_rank(ws1, ws2, lmat, h_ext, b: int, sup: int, num_lags: int,
                 want_idxs: bool = True, windows: int = 1, share_h: int = 1,
                 num_valid=None, want_top2: bool = False, sep: int = 0):
    """((K, P_eff) values, lags) of the coarse rank — with ``want_top2``
    (K1 mode (e)) also slot 2's values and lags: the kernel for CUDA
    tensors, the f32 plain version for CPU tensors (the JAX package's
    CPU route)."""
    lmat, h_ext = lmat.float(), h_ext.float()
    if lmat.device.type == "cpu":
        return coarse_rank_plain(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                                 windows=windows, share_h=share_h,
                                 num_valid=num_valid, want_top2=want_top2,
                                 sep=sep)
    return fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                            want_idxs=want_idxs, windows=windows,
                            share_h=share_h, num_valid=num_valid,
                            want_top2=want_top2, sep=sep)


def _batched_refine(ns, hs, freqs_all, vals_t, sample_rate, xcor_len: int,
                    num_valid: Optional[int] = None) -> CafPeak:
    """Per-pair exact re-score of a (P, K) coarse ranking, shared by the
    plain and banded batch paths (``ops/stein_rescore``, K5 on the card):
    12 candidates per pair (the hybrid plain / mainlobe-separated set);
    ``num_valid`` caps the plain picks so -inf padded bins never enter
    the re-score."""
    return stein_rescore(ns, hs, freqs_all, vals_t, sample_rate, xcor_len,
                         ns.shape[-1], num_valid)


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


def _batched_core(ns, hs, freqs_t, sample_rate, xcor_len: int,
                  block_len: int, refine: bool) -> torch.Tensor:
    """:func:`batched_stein_peak`'s compiled core (``ops/_graph``): the
    needles SUPER-padded (appended zero blocks add nothing to any
    correlation), :func:`_batched_stein_core`, the answer packed."""
    n = ns.shape[-1]
    return _pack(_batched_stein_core(pad_to(ns, n + (-n) % SUPER), hs,
                                     freqs_t, sample_rate, xcor_len,
                                     block_len, refine))


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


def _banded_core(ns, hs, freqs_pad, centers, rel, sample_rate,
                 xcor_len: int, block_len: int,
                 num_bins: int) -> torch.Tensor:
    """The banded batch's compiled core (``ops/_graph``; also the
    single-pair banded Stein path at P = 1): :func:`_banded_batched`,
    the answer packed."""
    return _pack(_banded_batched(ns, hs, freqs_pad, centers, rel,
                                 sample_rate, xcor_len, block_len,
                                 num_bins))


def _banded_call(ns, hs, plan, sample_rate: float, xcor_len: int,
                 num_bins: int):
    """The banded batch's compiled call over a band ``plan``: ``(core,
    traced, static, host grid, value dtype)``."""
    return (_banded_core, (ns, hs, *_band_tensors(plan, ns.device)),
            (sample_rate, xcor_len, plan["block_len"], num_bins),
            plan["freqs_pad"], ns.real.dtype)


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
    best_bin = torch.argmax(rowmax, dim=-1, keepdim=True)
    best_lag = torch.gather(rowlag, 1, best_bin)[:, 0]       # (P,)
    n, hay_len = needle_len, hs.shape[-1]
    guard = min(64, n // 4, max((hay_len - n) // 2, 0))
    win = n + 2 * guard
    start = torch.clamp(best_lag.long() - guard, 0, max(hay_len - win, 0))
    slices = torch.gather(hs, 1, start[:, None]
                          + torch.arange(win, device=hs.device)[None, :])
    # Local lags with full correlation energy, absolute lags in range.
    bound = torch.clamp(total_lags - 1 - start, max=2 * guard)
    pk = stein_rescore(ns, slices, freqs_all, rowmax, sample_rate, xcor_len,
                       needle_len, num_valid_bins, lag_bound=bound)
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
    return (ws1, ws2, lmat, h_ext), b, sup, {
        "windows": windows, "share_h": s,
        "num_valid": _window_bounds(total_lags, v, windows, p * s,
                                    ns.device)}


def _window_bounds(total_lags: int, v: int, windows: int, programs: int,
                   device) -> torch.Tensor:
    """(programs * windows,) int32 lag bounds, made on ``device``: the
    last window's range may end mid-window, and real capture samples past
    it must not shadow in-range peaks inside the per-bin max, so window
    ``w`` of each program is bounded by ``clip(total - w*V, 0, V)``."""
    w = torch.arange(windows, dtype=torch.int64, device=device)
    return torch.clamp(total_lags - w * v, 0, v).repeat(programs).to(
        torch.int32)


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


def _os_core(ns, hs, freqs_t, sample_rate, xcor_len: int, block_len: int,
             windows: int, total_lags: int, needle_len: int) -> torch.Tensor:
    """:func:`batched_stein_os_peak`'s compiled core (``ops/_graph``; the
    counterpart of JAX's ``_batched_stein_os_jit``): the needles
    SUPER-padded, :func:`_stein_os` on the grid, the answer packed."""
    n = ns.shape[-1]
    return _pack(_stein_os(pad_to(ns, n + (-n) % SUPER), hs, freqs_t, None,
                           freqs_t, sample_rate, xcor_len, block_len,
                           windows, total_lags, needle_len))


def _banded_os_core(ns, hs, freqs_pad, centers, rel, sample_rate,
                    xcor_len: int, block_len: int, windows: int,
                    total_lags: int, needle_len: int,
                    num_bins: int) -> torch.Tensor:
    """The banded windowed engine's compiled core (JAX's
    ``_banded_stein_os_jit``): :func:`_stein_os` over (pair, band,
    window) programs, the answer packed."""
    return _pack(_stein_os(ns, hs, freqs_pad, centers, rel, sample_rate,
                           xcor_len, block_len, windows, total_lags,
                           needle_len, num_bins))


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
    (:func:`caf_cookoff_tpu_torch.models._stein_plan._band_routing`), which
    covers spans the single-band envelope cannot take at all.  On a card
    the call is a compiled call (``ops/_graph``): one CUDA graph per
    shape and static argument, nothing read back but the packed answer.
    Every FFT ``backend`` name runs ``torch.fft``.
    """
    return _compiled_call(backend, _os_call, needles, haystacks, freqs_hz,
                          sample_rate, num_lags, block_len, device)


def _os_call(needles, haystacks, freqs_hz, sample_rate,
             num_lags: Optional[int], block_len: int, device):
    """:func:`batched_stein_os_peak`'s checks and routing: ``(core,
    traced, static, host grid, value dtype)`` of its compiled call, the
    banded core where the band plan wins."""
    ns, hs = _long_batch(needles, haystacks, device)
    n = ns.shape[-1]
    if hs.shape[-1] <= n:
        raise ValueError("use batched_stein_peak for equal-length pairs")
    freqs = signal_grid(freqs_hz, ns)
    fs = float(sample_rate)
    use_banded, d, freqs_pad, centers, rel = _windowed_route(
        fs, freqs, lambda: _pow2_block_len(fs, freqs, block_len))
    m = xcor_length(n)
    total_lags = num_lags or hs.shape[-1] - n + 1
    windows = -(-total_lags // m)
    dev = ns.device
    if use_banded:
        traced = (ns, hs, *(_as_tensor(x, dev)
                            for x in (freqs_pad, centers, rel)))
        return (_banded_os_core, traced,
                (fs, m, d, windows, total_lags, n, len(freqs)), freqs_pad,
                ns.real.dtype)
    return (_os_core, (ns, hs, _grid_on(freqs_hz, freqs, dev)),
            (fs, m, d, windows, total_lags, n), freqs, ns.real.dtype)


def batched_stein_peak(needles, haystacks, freqs_hz, sample_rate, *,
                       block_len: int = 64, refine: bool = True,
                       backend: Optional[str] = None, device=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair peaks for a (P, N) batch: (freqs (P,), lags (P,), values).

    Config 2's path: one coarse-rank launch for the whole batch, then
    one batched exact re-score — the same answers as
    :func:`caf_cookoff_tpu_torch.models.stein.stein_caf_peak` per pair.
    Grids past the single-segment envelope are banded, (pair, band) as
    the kernel's program axis.  On a card the call is a compiled call
    (``ops/_graph``): one CUDA graph per shape and static argument,
    nothing read back but the packed answer.  Every FFT ``backend``
    name runs ``torch.fft``.
    """
    return _compiled_call(backend, _batched_call, needles, haystacks,
                          freqs_hz, sample_rate, block_len, refine, device)


def _batched_call(needles, haystacks, freqs_hz, sample_rate,
                  block_len: int, refine: bool, device):
    """:func:`batched_stein_peak`'s checks and plan: ``(core, traced,
    static, host grid, value dtype)`` of its compiled call, the banded
    core for grids past the single-segment envelope."""
    ns, hs = _equal_batch(needles, haystacks, device)
    freqs = signal_grid(freqs_hz, ns)
    fs = float(sample_rate)
    n = ns.shape[-1]
    m = xcor_length(n)
    if m % FUSED_TILE:
        raise EligibilityError(
            f"xcor length {m} not a multiple of {FUSED_TILE}")
    try:
        d = _pow2_block_len(fs, freqs, block_len)
    except SpanError:
        # Wide-span batch: band the grid, (pair, band) as the programs.
        plan = _plan_bands(fs, freqs) if refine else None
        if plan is None:
            raise
        return _banded_call(ns, hs, plan, fs, m, len(freqs))
    # The coarse values (refine=False) are K1's f32 ranks.
    return (_batched_core, (ns, hs, _grid_on(freqs_hz, freqs, ns.device)),
            (fs, m, d, refine), freqs,
            ns.real.dtype if refine else torch.float32)


# ---------------------------------------------------------------------------
# Multi-emitter lattices (K1 mode (e))
# ---------------------------------------------------------------------------
#
# K1's top-2 mode gives, per (program, bin), two lag candidates more than
# ``exclude_lag`` apart; they fold into per-pair NMS lattices whose
# entries are re-scored EXACTLY on a guard-extended capture window around
# each entry's lag (the rank-then-score contract), and the lattice
# re-sorts and re-dedups on the exact values.  The port's K1(e) is exact
# for same-bin pairs more than ``exclude_lag`` apart (the JAX package's
# CPU twin's contract; its TPU kernel guarantees only past
# ``2*exclude_lag``).  A third same-bin emitter in one window needs the
# lattice scans of ``models/overlap_save``.


def _lattice_from_bin_candidates(vals_j, lags_j, num_peaks: int,
                                 exclude_freq: int, exclude_lag: int,
                                 bin_offset=0, num_bins: Optional[int] = None,
                                 lag_period: Optional[int] = None) -> CafPeak:
    """NMS lattices from (..., K, J) per-bin candidate slots (J slots a
    bin: K1's top-2, possibly stacked over windows), one per leading
    index.  Negative values are kernel sentinels and become -inf, so
    they can neither win nor suppress.  ``bin_offset`` (broadcastable to
    the leading axes) and ``num_bins``: banded grids report global bins
    ``offset + row`` on the ascending ``freqs_pad`` lattice, pad rows
    past ``num_bins`` masked."""
    k = vals_j.shape[-2]
    rows = (torch.as_tensor(bin_offset, device=vals_j.device)[..., None]
            + torch.arange(k, device=vals_j.device))
    bins = rows[..., None].expand(vals_j.shape)
    v = torch.where(vals_j < 0, -math.inf, vals_j)
    if num_bins is not None:
        v = torch.where(bins < num_bins, v, -math.inf)
    lead = vals_j.shape[:-2]
    cands = CafPeak(v.reshape(*lead, -1),
                    bins.reshape(*lead, -1).to(torch.int32),
                    lags_j.reshape(*lead, -1).to(torch.int32))
    return merge_peaks(cands, num_peaks, exclude_freq, exclude_lag,
                       lag_period=lag_period)


def _entry_candidate_bins(vals_flat, lags_flat, lag_e, bin_e,
                          exclude_lag: int, exclude_freq: int,
                          num_bins: int, lag_period: Optional[int] = None):
    """Exact-re-score candidate bins of every lattice entry: (P, K, J)
    coarse candidates (lags in the entries' coordinates), (P, E) entry
    lags and bins -> ((P, E, r) bins, (P, E, r) valid).

    The ranking keeps candidates within one lag cell of the entry's lag
    AND bins within one freq cell of the entry's own coarse bin — else a
    same-lag stronger emitter farther away in frequency would capture
    the re-score and collapse this entry onto it.  Top-``_REFINE_BINS``
    of the masked ranking (ties to the lower bin, as ``lax.top_k``);
    slots whose rank is -inf are invalid."""
    ok = ((_lag_distance(lags_flat[:, None], lag_e[..., None, None],
                         lag_period) <= exclude_lag)
          & (vals_flat[:, None] >= 0))
    rank = torch.amax(torch.where(ok, vals_flat[:, None], -math.inf),
                      dim=-1)                                 # (P, E, K)
    bins_all = torch.arange(num_bins, device=rank.device)
    rank = torch.where((bins_all - bin_e[..., None]).abs() <= exclude_freq,
                       rank, -math.inf)
    r = min(_REFINE_BINS, num_bins)
    sel_rank, bins = torch.sort(rank, dim=-1, descending=True, stable=True)
    return bins[..., :r].to(torch.int32), torch.isfinite(sel_rank[..., :r])


def _rescore_guards(needle_len: int, auto_lag_cell: int,
                    hay_len: int) -> Tuple[int, int]:
    """(guard, rescore_win) of the per-entry exact re-score windows: the
    window holds the whole needle plus ``guard`` samples each side; the
    argmax slack around the coarse lag is resolution-derived (at least 4
    samples, for bf16 flat-top ties) and clamped to the guard."""
    win = max(int(auto_lag_cell), 4)
    guard = min(max(64, win), max(needle_len // 4, 1),
                max((hay_len - needle_len) // 2, 1))
    return guard, min(win, guard)


def _windows_at(sig: torch.Tensor, start: torch.Tensor, wlen: int):
    """(P, E, wlen) slices ``sig[p, start[p, e]:start[p, e] + wlen]`` of a
    (P, L) batch."""
    idx = start[..., None] + torch.arange(wlen, device=sig.device)
    return torch.gather(sig[:, None, :].expand(-1, start.shape[1], -1), 2,
                        idx)


def _rescore_rows(ns, windows, freqs, bins, keep, sample_rate,
                  xcor_len: int) -> CafPeak:
    """One batched exact re-score over every (pair, entry, candidate bin)
    row: (P, E) (value, row, window-local lag) of the kept cells."""
    exact = mag2(_surface_rows(ns[:, None, :], windows, freqs[bins.long()],
                               sample_rate, xcor_len))      # (P, E, r, M)
    return find_peak_2d(torch.where(keep, exact, -math.inf))


def _rescore_entries_circular(ns, circ, freqs, vals_j, lags_j, lat: CafPeak,
                              sample_rate, xcor_len: int, guard: int,
                              rescore_win: int, exclude_lag: int,
                              exclude_freq: int):
    """Exact re-score of each pair's coarse lattice — CIRCULAR lags.

    ``circ``: (P, M + wlen) haystacks zero-padded to the period M and
    tiled past the wrap, so the window from ``(lag - guard) mod M``
    holds the samples circular lag ``lag`` correlates against; local lag
    ``d <= 2*guard`` is circular lag ``(start + d) mod M``.  The argmax
    is held to ``|d - guard| <= rescore_win``, one cell around the
    entry's own coarse lag, so a nearby stronger emitter cannot capture
    it.  Returns (P, E) values, bins, lags."""
    m = xcor_len
    wlen = ns.shape[-1] + 2 * guard
    bins, bok = _entry_candidate_bins(vals_j, lags_j, lat.lag_idx,
                                      lat.freq_idx, exclude_lag,
                                      exclude_freq, freqs.shape[0],
                                      lag_period=m)
    start = torch.remainder(lat.lag_idx.long() - guard, m)
    d = torch.arange(m, device=circ.device)
    keep = (bok[..., None] & (d <= 2 * guard)
            & ((d - guard).abs() <= rescore_win))
    pk = _rescore_rows(ns, _windows_at(circ, start, wlen), freqs, bins, keep,
                       sample_rate, m)
    return (torch.where(torch.isfinite(lat.value), pk.value, -math.inf),
            bins.gather(-1, pk.freq_idx.long()[..., None])[..., 0],
            torch.remainder(lat.lag_idx + pk.lag_idx - guard,
                            m).to(torch.int32))


def _rescore_entries_windowed(ns, hs, freqs, vals_j, lags_j, lat: CafPeak,
                              sample_rate, xcor_len: int, total_lags: int,
                              guard: int, rescore_win: int,
                              exclude_lag: int, exclude_freq: int):
    """Exact re-score of each pair's coarse lattice — LINEAR capture lags
    (the overlap-save engines): a guard-extended slice of the raw
    capture around each entry's lag, local lags held to full overlap,
    the requested lag bound and one cell around the entry's own coarse
    lag (see :func:`_rescore_entries_circular`)."""
    wlen = ns.shape[-1] + 2 * guard
    hay_len = hs.shape[-1]
    bins, bok = _entry_candidate_bins(vals_j, lags_j, lat.lag_idx,
                                      lat.freq_idx, exclude_lag,
                                      exclude_freq, freqs.shape[0])
    start = torch.clamp(lat.lag_idx.long() - guard, 0,
                        max(hay_len - wlen, 0))
    d = torch.arange(xcor_len, device=hs.device)
    glob = start[..., None, None] + d                       # (P, E, 1, M)
    keep = (bok[..., None] & (d <= 2 * guard) & (glob < total_lags)
            & ((glob - lat.lag_idx[..., None, None]).abs() <= rescore_win))
    pk = _rescore_rows(ns, _windows_at(hs, start, wlen), freqs, bins, keep,
                       sample_rate, xcor_len)
    return (torch.where(torch.isfinite(lat.value), pk.value, -math.inf),
            bins.gather(-1, pk.freq_idx.long()[..., None])[..., 0],
            (start + pk.lag_idx).to(torch.int32))


def _batched_stein_peaks_core(ns, hs, freqs_t, sample_rate, xcor_len: int,
                              block_len: int, num_peaks: int,
                              exclude_freq: int, exclude_lag: int,
                              guard: int, rescore_win: int) -> CafPeak:
    """Equal-length multi-emitter batch: one program per pair with K1's
    top-2 mode (b+e), per-pair lattices on circular lags, the per-entry
    exact re-score and the re-dedup.  Fields (P, num_peaks)."""
    n, m = ns.shape[-1], xcor_len
    ops, b, sup, _ = _batch_operands(pad_to(ns, n + (-n) % SUPER), hs,
                                     freqs_t, sample_rate, m, block_len)
    v1, i1, v2, i2 = _coarse_rank(*ops, b, sup, m, want_top2=True,
                                  sep=exclude_lag)           # (K, P) each
    vals_j = torch.stack([v1, v2], dim=-1).permute(1, 0, 2)   # (P, K, 2)
    lags_j = torch.stack([i1, i2], dim=-1).permute(1, 0, 2)
    lat = _lattice_from_bin_candidates(vals_j, lags_j, num_peaks,
                                       exclude_freq, exclude_lag,
                                       lag_period=m)
    base = pad_to(hs, m)
    circ = torch.cat([base, base[:, :n + 2 * guard]], dim=-1)
    vals_e, bins_e, lags_e = _rescore_entries_circular(
        ns, circ, freqs_t, vals_j, lags_j, lat, sample_rate, m, guard,
        rescore_win, exclude_lag, exclude_freq)
    # Two coarse cells can re-score onto one exact peak (a doppler
    # sidelobe past the bin exclusion): re-dedup and re-sort on the
    # exact values, circularly.
    return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                       exclude_freq, exclude_lag, lag_period=m)


def _stein_os_peaks(ns, hs, freqs_all, centers, rel, sample_rate,
                    xcor_len: int, block_len: int, windows: int,
                    total_lags: int, num_peaks: int, exclude_freq: int,
                    exclude_lag: int, guard: int, rescore_win: int,
                    num_bins: Optional[int] = None) -> CafPeak:
    """Long-capture multi-emitter scan: one program per (pair[, band],
    window) with K1's top-2 mode ((d+e), banded (c+d+e)), one NMS lattice
    per program on global bins and lags, folded per pair (hierarchical:
    slots at sidelobe level may differ from a flat fold), then the
    per-entry exact re-score on absolute frequencies with the unshifted
    needles and the re-dedup.  ``ns`` are the unpadded needles; banded
    when ``centers`` is given (global bin ``band*Kb + j``, -inf past
    ``num_bins``).  Fields (P, num_peaks), lags absolute."""
    p, v, n = ns.shape[0], xcor_len, ns.shape[-1]
    ns_k = ns if centers is not None else pad_to(ns, n + (-n) % SUPER)
    ops, b, sup, modes = _os_operands(ns_k, hs, centers, rel, sample_rate,
                                      v, block_len, windows, total_lags)
    v1, i1, v2, i2 = _coarse_rank(*ops, b, sup, v, want_top2=True,
                                  sep=exclude_lag, **modes)
    kb, s = rel.shape[0], modes["share_h"]
    woff = torch.arange(windows, dtype=torch.int32, device=ns.device) * v
    vals_j = torch.stack([v1, v2], dim=-1).reshape(kb, p, s, windows, 2)
    lags_j = (torch.stack([i1, i2], dim=-1).reshape(kb, p, s, windows, 2)
              + woff[:, None])
    vals_j = torch.where(lags_j < total_lags, vals_j, -1.0)
    vals_j = vals_j.permute(1, 2, 3, 0, 4)                 # (P, S, W, Kb, 2)
    lags_j = lags_j.permute(1, 2, 3, 0, 4)
    offs = torch.arange(s, device=ns.device) * kb
    wlat = _lattice_from_bin_candidates(vals_j, lags_j, num_peaks,
                                        exclude_freq, exclude_lag,
                                        bin_offset=offs[:, None],
                                        num_bins=num_bins)
    lat = merge_peaks(CafPeak(*(f.reshape(p, -1) for f in wlat)), num_peaks,
                      exclude_freq, exclude_lag)
    # Per pair, the candidate slots on the global lattice as (S*Kb, W*2);
    # pad rows go negative so the re-score's bin ranking skips them.
    vflat = vals_j.permute(0, 1, 3, 2, 4).reshape(p, s * kb, -1)
    lflat = lags_j.permute(0, 1, 3, 2, 4).reshape(p, s * kb, -1)
    if num_bins is not None:
        rows = torch.arange(s * kb, device=ns.device)
        vflat = torch.where(rows[None, :, None] < num_bins, vflat, -1.0)
    vals_e, bins_e, lags_e = _rescore_entries_windowed(
        ns, hs, freqs_all, vflat, lflat, lat, sample_rate, xcor_len,
        total_lags, guard, rescore_win, exclude_lag, exclude_freq)
    return merge_peaks(CafPeak(vals_e, bins_e, lags_e), num_peaks,
                       exclude_freq, exclude_lag)


def _stein_model_floor(needles: np.ndarray, haystacks: np.ndarray,
                       valid_len=None) -> np.ndarray:
    """(P,) per-pair model noise floor ``sum|n|^2 * mean|h|^2`` (host
    numpy): the fused kernel reduces bins to maxima, so there are no
    cells to measure; a noise-only xcor cell has that second moment.
    ``valid_len`` (a scalar or one per pair) restricts each haystack
    mean to its real samples, so zero padding cannot bias it low."""
    needles = np.asarray(needles)
    haystacks = np.asarray(haystacks)
    n_energy = np.sum(np.abs(needles) ** 2, axis=-1, dtype=np.float64)
    if valid_len is None:
        h_mean = np.mean(np.abs(haystacks) ** 2, axis=-1, dtype=np.float64)
    else:
        lens = np.broadcast_to(np.asarray(valid_len, np.int64),
                               (haystacks.shape[0],))
        h_mean = np.array([
            np.mean(np.abs(haystacks[i, :lens[i]]) ** 2, dtype=np.float64)
            for i in range(haystacks.shape[0])])
    return n_energy * h_mean


def _exclusions(ns, freqs, sample_rate, exclude_freq, exclude_lag):
    """(exclude_freq, exclude_lag, auto lag cell): unset windows default
    to the first needle's resolution cell."""
    auto = resolve_exclusions(ns[0], freqs, sample_rate, None, None)
    return (auto[0] if exclude_freq is None else int(exclude_freq),
            auto[1] if exclude_lag is None else int(exclude_lag), auto[1])


def batched_stein_peaks(needles, haystacks, freqs_hz, sample_rate,
                        num_peaks: int, *, block_len: int = 64,
                        exclude_freq: Optional[int] = None,
                        exclude_lag: Optional[int] = None,
                        backend: Optional[str] = None, min_snr_db=None,
                        with_snr: bool = False, device=None):
    """Top-``num_peaks`` emitters PER PAIR of an equal-length (P, N)
    batch through K1's top-2 mode: ``(freqs (P, k), lags (P, k), values
    (P, k)[, snr_db])``, strongest first, empty slots -inf.  Lags are
    CIRCULAR xcor indices (unwrap with ``ops.peak.unwrap_lag``).
    ``min_snr_db`` / ``with_snr`` threshold against the per-pair model
    floor (:func:`_stein_model_floor`).  Grids past the single-band
    envelope raise ``EligibilityError`` (no banding here: use
    ``find_peaks`` on ``caf_surface``, or the overlap-save lattices)."""
    resolve_backend(backend)
    ns, hs = _equal_batch(needles, haystacks, device)
    freqs = signal_grid(freqs_hz, ns)
    fs = float(sample_rate)
    n = ns.shape[-1]
    m = xcor_length(n)
    try:
        d = _pow2_block_len(fs, freqs, block_len)
    except SpanError as e:
        raise EligibilityError(
            f"{e} — the multi-emitter fused engine does not band wide "
            "spans; use find_peaks on caf_surface or the overlap-save "
            "lattice engines for this grid") from e
    ef, el, auto_lag = _exclusions(ns, freqs, fs, exclude_freq, exclude_lag)
    # The circular extension (period m) imposes no window-fit limit: m,
    # not n, or the guard collapses to 1.
    guard, rescore_win = _rescore_guards(n, auto_lag, m)
    pk = _batched_stein_peaks_core(ns, hs, _as_tensor(freqs, ns.device), fs,
                                   m, d, int(num_peaks), ef, el, guard,
                                   rescore_win)
    if min_snr_db is None and not with_snr:
        return _host(freqs, pk)
    return detection_rows(freqs, pk, _stein_model_floor(ns.cpu().numpy(),
                                                        hs.cpu().numpy()),
                          len(freqs) * m, min_snr_db, with_snr)


def batched_stein_os_peaks(needles, haystacks, freqs_hz, sample_rate,
                           num_peaks: int, num_lags: Optional[int] = None, *,
                           block_len: int = 64,
                           exclude_freq: Optional[int] = None,
                           exclude_lag: Optional[int] = None,
                           backend: Optional[str] = None, min_snr_db=None,
                           with_snr: bool = False, capture_lens=None,
                           device=None):
    """Top-``num_peaks`` emitters PER PAIR of long captures through K1's
    top-2 mode (config 4's multi-emitter workload): ``(freqs (P, k), lags
    (P, k), values (P, k)[, snr_db (P, k)])``, strongest first, lags
    absolute capture offsets, empty and sub-threshold slots -inf.

    Exclusion windows default to the first needle's resolution cell;
    ``min_snr_db`` / ``with_snr`` threshold against the per-pair model
    floor (``capture_lens``: each pair's real capture length, so batch
    padding cannot bias it).  Uniform grids route banded whenever the
    band plan's modelled cost wins (as :func:`batched_stein_os_peak`);
    a grid that neither fits the single-band envelope nor bands raises
    ``EligibilityError`` (use :func:`caf_cookoff_tpu_torch.models.
    overlap_save.batched_overlap_save_peaks_local`)."""
    resolve_backend(backend)
    ns, hs = _long_batch(needles, haystacks, device)
    n = ns.shape[-1]
    if hs.shape[-1] <= n:
        raise ValueError("use batched_stein_peaks for equal-length pairs")
    freqs = signal_grid(freqs_hz, ns)
    fs = float(sample_rate)
    try:
        use_banded, d, freqs_pad, centers, rel = _windowed_route(
            fs, freqs, lambda: _pow2_block_len(fs, freqs, block_len))
    except SpanError as span_err:
        raise EligibilityError(
            f"{span_err} — this grid neither fits the single-band envelope "
            "nor bands cleanly; use batched_overlap_save_peaks_local "
            "(the lattice scan) for it") from span_err
    m = xcor_length(n)
    total_lags = num_lags or hs.shape[-1] - n + 1
    windows = -(-total_lags // m)
    ef, el, auto_lag = _exclusions(ns, freqs, fs, exclude_freq, exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto_lag, hs.shape[-1])
    dev = ns.device
    out_freqs = freqs_pad if use_banded else freqs
    pk = _stein_os_peaks(
        ns, hs, _as_tensor(out_freqs, dev),
        _as_tensor(centers, dev) if use_banded else None,
        _as_tensor(rel, dev), fs, m, d, windows, total_lags,
        int(num_peaks), ef, el, guard, rescore_win,
        num_bins=len(freqs) if use_banded else None)
    if min_snr_db is None and not with_snr:
        return _host(out_freqs, pk)
    return detection_rows(
        out_freqs, pk,
        _stein_model_floor(ns.cpu().numpy(), hs.cpu().numpy(),
                           valid_len=capture_lens),
        len(freqs) * total_lags, min_snr_db, with_snr)
