"""Stein time-segmented CAF — fast fine-grid doppler search.

    r_k[tau] = sum_s h[s+tau] conj(n[s]) e^{-j w_k s}
             ~ sum_b e^{-j w_k (bD + c)} * G[b, tau]
      where  G[b, tau] = sum_{d<D} h[bD+d+tau] conj(n[bD+d]),  c = (D-1)/2

* Stage A — segment correlations ``G`` (B = N/D needle blocks against
  the haystack).
* Stage B — doppler synthesis ``R = W @ G``.

The main path (:func:`stein_caf_peak`, ``fused`` on the card wherever
eligible) runs both stages and the per-bin rank in the fused kernel
(``ops/fused_stein``), then re-scores the top candidate bins with exact
filterbank rows, which restores bin-exact answers.  ``fused=False``
runs the FFT stage A and a matmul synthesis instead.  Spans past the
single-segment envelope are banded (:func:`_plan_bands`): one kernel
program per band.  Long captures (:func:`stein_overlap_save_peak`) run
the windowed engine of ``models/batched_stein`` on the card, or a
block-loop overlap-save scan with Stein synthesis.

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
from caf_cookoff_tpu_torch.errors import (EligibilityError, EngineError,
                                          SpanError)
from caf_cookoff_tpu_torch.models.batched_stein import (_band_tensors,
                                                        _banded_core,
                                                        _compiled_call,
                                                        _grid_on,
                                                        _haystack_extension,
                                                        _needle_operator,
                                                        _pack)
from caf_cookoff_tpu_torch.ops.fused_stein import (SUPER, block_centers,
                                                   fused_span,
                                                   fused_stein_rank,
                                                   stein_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import CafPeak, find_peak_2d
from caf_cookoff_tpu_torch.ops.shift import numpy_real, real_dtype_of
from caf_cookoff_tpu_torch.ops.stein_rescore import stein_rescore
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal


def _block_twist(num_blocks: int, block_len: int, m: int, rdtype,
                 device) -> torch.Tensor:
    """(B, M) ``exp(-2 pi j (b D) k / M)``, the shift theorem's twist of
    each block's spectrum to its true offset: the angles exact in f64
    on ``device`` (the products are integers), cos / sin rounded to
    ``rdtype``."""
    bd = torch.arange(num_blocks, dtype=torch.float64,
                      device=device) * block_len
    ang = (-2.0 * np.pi / m) * (
        bd[:, None] * torch.arange(m, dtype=torch.float64, device=device))
    return torch.complex(torch.cos(ang).to(rdtype), torch.sin(ang).to(rdtype))


def _segment_correlations(needle: torch.Tensor, haystack: torch.Tensor,
                          xcor_len: int, block_len: int) -> torch.Tensor:
    """G (B, M) complex: per-needle-block correlations vs the haystack,
    each block's spectrum twisted to its true offset (shift theorem)."""
    n = needle.shape[-1]
    d = block_len
    b = -(-n // d)
    m = xcor_len
    blocks = pad_to(needle, b * d).reshape(b, d)
    s0 = torch.fft.fft(pad_to(blocks, m), dim=-1)         # at-origin
    s_b = s0 * _block_twist(b, d, m, real_dtype_of(needle.dtype),
                            needle.device)
    h_spec = torch.fft.fft(pad_to(haystack, m))
    return torch.fft.ifft(h_spec[None, :] * torch.conj(s_b), dim=-1)


def _doppler_synthesis(g: torch.Tensor, freqs_hz: torch.Tensor,
                       sample_rate, block_len: int):
    """R = W @ G as one stacked real matmul over the segment axis;
    returns (Rr, Ri), each (K, M)."""
    gr, gi = g.real, g.imag
    b = gr.shape[0]
    rdtype = gr.dtype
    np_dt = numpy_real(rdtype)
    scale = float(np_dt(-2.0 * math.pi) / np_dt(sample_rate))
    w = scale * torch.outer(freqs_hz.to(rdtype),
                            block_centers(b, block_len, rdtype, g.device))
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


def _stein_core(needle, haystack, freqs_hz, sample_rate, xcor_len: int,
                block_len: int, refine: bool, fused: bool) -> torch.Tensor:
    """:func:`stein_caf_peak`'s compiled core (``ops/_graph``; the
    counterpart of JAX's ``_stein_peak_jit``): :func:`_stein_peak`, the
    answer packed."""
    return _pack(_stein_peak(needle, haystack, freqs_hz, sample_rate,
                             xcor_len, block_len, refine, fused))


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


def _refine_topk(needle, haystack, freqs_all, rowmax_coarse, sample_rate,
                 xcor_len: int, num_valid: Optional[int] = None) -> CafPeak:
    """Exact re-score of the coarse ranking (``ops/stein_rescore``, K5
    on the card): highest exact value wins, exact ties break toward the
    lowest bin."""
    return stein_rescore(needle, haystack, freqs_all, rowmax_coarse,
                         sample_rate, xcor_len, needle.shape[-1], num_valid)


def _plan_bands(sample_rate: float, freqs_hz: np.ndarray,
                margin_hz: float = 0.0, d_cap: Optional[int] = None):
    """Band partition for wide-span grids, or ``None`` if infeasible.

    Only uniform grids band cleanly: every band then shares one relative
    grid, so the sweep is one kernel call with the bands on the program
    axis.  Bands are sized so the relative |f| stays within the
    block-constant phase envelope.  Per lag column stage A costs ~4N MACs per
    band and the synthesis ~4*kb*N/D, so ``s*(1 + kb/D)`` (units of 4N)
    is evaluated at every pow2 block length and the cheapest wins.

    ``margin_hz`` shrinks every band by an allowance consumed elsewhere
    (the rate engines' ``|r|_max * T`` dechirp drift); ``d_cap`` excludes
    block lengths above it (their quadratic-residual cap).
    """
    k = len(freqs_hz)
    if k < 2:
        return None
    diffs = np.diff(np.asarray(freqs_hz, np.float64))
    g = float(diffs[0])
    if g <= 0 or not np.allclose(diffs, g, rtol=1e-5, atol=1e-9):
        return None
    best = None
    for cand in (8, 16, 32, 64, 128):
        if d_cap is not None and cand > d_cap:
            continue
        # Widest band the phase-error envelope allows at this D:
        # rel_max + margin <= fs/(4D)  =>  kb <= 2*(fs/(4D) - margin)/g.
        width = sample_rate / (4.0 * cand) - float(margin_hz)
        if width <= 0:
            continue
        kb_c = max(1, int(2.0 * width / g))
        s_c = -(-k // kb_c)
        cost = s_c * (1.0 + kb_c / cand)
        if best is None or cost < best[0]:
            best = (cost, cand, kb_c)
    if best is None:
        return None
    _, d, kb = best
    s = -(-k // kb)
    f0 = float(freqs_hz[0])
    freqs_pad = (f0 + g * np.arange(s * kb)).astype(np.float32)
    centers = (f0 + g * (np.arange(s) * kb + (kb - 1) / 2.0)).astype(
        np.float32)
    rel = (g * (np.arange(kb) - (kb - 1) / 2.0)).astype(np.float32)
    return {"block_len": d, "kb": kb, "bands": s, "freqs_pad": freqs_pad,
            "centers": centers, "rel": rel}


def _band_routing(sample_rate, freqs_np, d: Optional[int], *,
                  margin_hz: float = 0.0, d_cap: Optional[int] = None):
    """Banded-vs-plain routing of the windowed engines.

    ``d`` is the plain-envelope block length (``None`` when the plain
    path is ineligible).  Returns ``(use_banded, d_eff, freqs_pad,
    centers, rel)``: the one-band values (``centers=[0]``,
    ``rel=freqs_pad=freqs``) for the plain route, the band plan's arrays
    otherwise; ``d_eff`` is ``None`` when neither route is eligible.
    The banded route wins when the cost model (``s*(1 + kb/D)`` vs
    ``1 + K/D``) says it is at least ~10% cheaper.  ``margin_hz`` and
    ``d_cap`` go to :func:`_plan_bands`.
    """
    plan = _plan_bands(float(sample_rate), freqs_np, margin_hz=margin_hz,
                       d_cap=d_cap)
    use_banded = False
    if plan is not None:
        if d is None:
            use_banded = True
        else:
            cost_plain = 1.0 + len(freqs_np) / d
            cost_band = (plan["bands"]
                         + plan["bands"] * plan["kb"] / plan["block_len"])
            use_banded = cost_band < 0.9 * cost_plain
    if use_banded:
        return (True, plan["block_len"], np.asarray(plan["freqs_pad"]),
                np.asarray(plan["centers"]), np.asarray(plan["rel"]))
    return (False, d, np.asarray(freqs_np), np.zeros(1, np.float32),
            np.asarray(freqs_np))


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
    return n, h, freqs, _grid_on(freqs_hz, freqs, n.device)


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
    kernel where the shape is eligible (a pow2 block length >= 8 and a
    512-multiple correlation length) and the tensors are not on the
    CPU, as the JAX package takes it only off the CPU.  On the CPU the
    coarse rank is the f32 segmented rows; ``fused=True`` runs the
    kernel's plain version there, with the kernel's bf16 roundings.
    Every FFT ``backend`` name runs ``torch.fft``.

    Doppler spans past the single-segment envelope run the banded path
    (``refine=True``, ``fused=None``, a uniform grid): the grid splits
    into bands, the needle is shifted to each band centre (exact: shifts
    compose), and the bands are the programs of one kernel call.

    On a card the call is a compiled call (``ops/_graph``), as JAX's is
    one jitted program: one CUDA graph per shape and static argument,
    captured at its first call and replayed after; nothing is read back
    but the packed answer.
    """
    # The banded core answers a batch of one pair.
    freq, lag, value = (np.ravel(x)[0] for x in _compiled_call(
        backend, _stein_call, needle, haystack, freqs_hz, sample_rate,
        block_len, refine, fused, device))
    return float(freq), int(lag), float(value)


def _stein_call(needle, haystack, freqs_hz, sample_rate, block_len: int,
                refine: bool, fused: Optional[bool], device):
    """:func:`stein_caf_peak`'s checks and routing: ``(core, traced,
    static, host grid, value dtype)`` of its compiled call."""
    n, h, freqs, freqs_t = _prep(needle, haystack, freqs_hz, device)
    xl = xcor_length(n.shape[-1])
    fs = float(sample_rate)
    try:
        block_len = _auto_block_len(fs, freqs, block_len)
    except SpanError:
        # An explicit fused flag pins the single-band engines, which
        # cannot take the span.
        plan = _plan_bands(fs, freqs) if refine and fused is None else None
        if plan is None or xl % 512:
            raise
        # The P = 1 case of the banded batch engine (the band centres
        # become the kernel's programs through ``share_h``).
        traced = (n[None], h[None], *_band_tensors(plan, n.device))
        return (_banded_core, traced, (fs, xl, plan["block_len"], len(freqs)),
                plan["freqs_pad"], n.real.dtype)
    d_fused = floor_pow2(min(block_len, SUPER))
    eligible = refine and d_fused >= 8 and xl % 512 == 0
    if fused is None:
        fused = eligible and n.device.type != "cpu"
    if fused:
        if not eligible:
            raise EligibilityError(
                f"fused kernel needs refine=True, a pow2 block length "
                f">= 8 (got {block_len} -> {d_fused}) and a 512-multiple "
                f"correlation length (got {xl}); use fused=False")
        block_len = d_fused
    return (_stein_core, (n, h, freqs_t), (fs, xl, block_len, refine, fused),
            freqs, n.real.dtype)


def _segment_spectra_conj(needle: torch.Tensor, fft_len: int,
                          block_len: int) -> torch.Tensor:
    """(B, M) conj spectra of the needle's D-blocks at their true
    offsets (doppler-independent, computed once per needle)."""
    n = needle.shape[-1]
    d = block_len
    b = -(-n // d)
    m = fft_len
    s0 = torch.fft.fft(pad_to(pad_to(needle, b * d).reshape(b, d), m),
                       dim=-1)
    return torch.conj_physical(s0 * _block_twist(
        b, d, m, real_dtype_of(needle.dtype), needle.device))


def _stein_os_scan(needle, haystack, freqs_t, sample_rate, num_lags: int,
                   block_len: int) -> CafPeak:
    """Block-loop overlap-save peak with Stein doppler synthesis: per
    haystack block one FFT, B_seg = N/D inverse FFTs (the segment
    correlations) and one (2K, 2B_seg) x (2B_seg, V) synthesis product.
    The peak carry stays on the device; the strict ``>`` keeps the
    earliest block on ties."""
    from caf_cookoff_tpu_torch.models.overlap_save import plan_blocks

    needle_len = needle.shape[-1]
    m, v, nblocks = plan_blocks(needle_len, num_lags)
    d_read = v + needle_len - 1
    sc = _segment_spectra_conj(needle, m, block_len)
    target = nblocks * v + needle_len - 1
    hay = (haystack[:target] if haystack.shape[-1] >= target
           else pad_to(haystack, target))
    dev = needle.device
    best = CafPeak(value=torch.tensor(-math.inf, dtype=freqs_t.dtype,
                                      device=dev),
                   freq_idx=torch.zeros((), dtype=torch.int32, device=dev),
                   lag_idx=torch.zeros((), dtype=torch.int32, device=dev))
    local = torch.arange(v, device=dev)
    for blk in range(nblocks):
        spec = torch.fft.fft(pad_to(hay[blk * v:blk * v + d_read], m))
        g = torch.fft.ifft(spec[None, :] * sc, dim=-1)[:, :v]
        rr, ri = _doppler_synthesis(g, freqs_t, sample_rate, block_len)
        surface = torch.where(local + blk * v < num_lags,
                              rr * rr + ri * ri, -1.0)
        cand = find_peak_2d(surface)
        take = cand.value > best.value    # strict: earlier block wins ties
        best = CafPeak(
            value=torch.where(take, cand.value, best.value),
            freq_idx=torch.where(take, cand.freq_idx, best.freq_idx),
            lag_idx=torch.where(take, cand.lag_idx + blk * v,
                                best.lag_idx))
    return best


def _use_windowed_engine(scan_block, device: torch.device) -> bool:
    """Gate for the batched windowed engine inside the long-capture
    path: mandatory when the scan cannot take the span (banded only),
    otherwise taken on the card and skipped on the CPU, as the JAX
    package prefers it on its accelerator and not on the CPU."""
    return scan_block is None or device.type != "cpu"


def _prep_long(needle, haystack, freqs_hz, device):
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    if h.shape[-1] < n.shape[-1]:
        raise ValueError(f"haystack ({h.shape[-1]}) shorter than needle "
                         f"({n.shape[-1]})")
    rdtype = np.float64 if n.dtype == torch.complex128 else np.float32
    freqs = as_grid(freqs_hz, dtype=rdtype)
    return n, h, freqs, _grid_on(freqs_hz, freqs, n.device)


def stein_overlap_save_peak(needle, haystack, freqs_hz, sample_rate, *,
                            block_len: int = 64,
                            num_lags: Optional[int] = None,
                            refine: bool = True,
                            backend: Optional[str] = None,
                            device=None) -> Tuple[float, int, float]:
    """Long-haystack (freq, lag, value) via segmented doppler synthesis.

    On the card (and for spans only the banded engine takes) with
    ``refine=True`` the coarse pass is the windowed fused engine
    (:func:`~caf_cookoff_tpu_torch.models.batched_stein.
    batched_stein_os_peak` at P=1): every overlap-save lag window, and
    every band where the band planner favours it, is one program of the
    kernel.  Shapes outside its envelope fall back to the block-loop
    scan.  The scan ranks all lags (lag exact, frequency within a bin),
    then a guard-extended capture window at the found lag is re-scored
    by :func:`stein_caf_peak`'s exact path, restoring the bin-exact
    frequency.  Every FFT ``backend`` name runs ``torch.fft``.
    """
    from caf_cookoff_tpu_torch.models.batched_stein import (
        batched_stein_os_peak)

    resolve_backend(backend)
    n, h, freqs, freqs_t = _prep_long(needle, haystack, freqs_hz, device)
    fs = float(sample_rate)
    try:
        scan_block = _auto_block_len(fs, freqs, block_len)
        span_err = None
    except SpanError as e:
        scan_block, span_err = None, e  # past the single-segment envelope
    if (refine and h.shape[-1] > n.shape[-1]
            and _use_windowed_engine(scan_block, n.device)):
        try:
            fr, lg, vv = batched_stein_os_peak(
                n[None], h[None], freqs, fs, num_lags=num_lags,
                block_len=block_len, device=n.device)
            return float(fr[0]), int(lg[0]), float(vv[0])
        except EngineError:
            # Only the typed envelope conditions reroute, to the scan on
            # the same device; anything else propagates.
            if scan_block is None:
                raise    # the scan cannot take the span either
    if scan_block is None:
        raise span_err
    nl = n.shape[-1]
    lags = num_lags or h.shape[-1] - nl + 1
    peak = _stein_os_scan(n, h, freqs_t, fs, lags, scan_block)
    lag = int(peak.lag_idx)
    if not refine:
        return float(freqs[int(peak.freq_idx)]), lag, float(peak.value)
    # Exact re-score of a guard-extended window starting slightly before
    # the coarse lag: ``n + 2*guard`` samples, so the winning local lag
    # (~guard) correlates every needle sample against real data.
    guard = min(lag, 64, nl // 4)
    start = lag - guard
    win_len = min(nl + 2 * guard, xcor_length(nl))
    avail = min(win_len, h.shape[-1] - start)
    window = pad_to(h[start:start + avail], win_len)
    freq, delta, value = stein_caf_peak(n, window, freqs, fs,
                                        block_len=scan_block,
                                        device=n.device)
    return freq, start + int(delta), value
