"""Fused Stein coarse rank: the CUDA kernel's wrapper and its plain
PyTorch version.

Per (program, doppler bin) the rank is the max over lags of
``|ws1 @ G|^2 + |ws2 @ G|^2`` and the lowest lag attaining it, where
``G`` are the needle's segment correlations built from a Hankel view of
a haystack extension (stage A) — the contract of the JAX package's
``fused_stein_rank`` and its XLA twin ``_coarse_rank_xla``.  Operand
shapes are the JAX package's, so the same numpy operands feed both.

Programs: ``P_eff = P * share_h * windows``, band-major
(``i = (pair*S + band)*W + w``).  Program ``i`` reads the needle
operator ``lmat[i // W]`` and the haystack slice
``h_ext[(i // (S*W))*W + i % W]`` — bands share a pair's haystack,
windows share a pair's needle (:func:`program_maps`).  ``num_valid``
bounds each program's lags.

* :func:`fused_stein_rank` launches ``csrc/fused_stein.cu`` for CUDA
  tensors (or raises) and runs the plain version for CPU tensors.
* :func:`coarse_rank_plain` is that plain version; ``emulate_bf16=True``
  applies the kernel's roundings (inputs and G to bf16, f32 sums, stage
  A summed in the kernel's order so that G is the kernel's bit for bit);
  :func:`coarse_surface_plain` with ``emulate_bf16=True`` also sums stage
  B row by row (the CPU route's |R|^2).  The kernel sums stage B on the
  tensor cores in their own order, so it is held to an error bound
  instead: :func:`stage_b_error_bound` (the f64 stage B on the plain
  version's G and the bound of each |R|^2) and :func:`rank_bound_check`
  (a kernel answer against it).
* ``want_top2=True`` (K1 mode (e)) adds, per (program, bin), the
  strongest lag more than ``sep`` from the first (:func:`top2_separated`:
  value -1.0 and lag 0 when there is none) — exact for any separation
  past ``sep``, where the TPU kernel's tile merge guarantees only past
  ``2*sep``.
* Two tile launches: the pipelined one (persistent blocks whose
  producer warps build G tiles while a warpgroup runs their products on
  ``wgmma``) wherever :func:`pipelined` takes the shape, else the tile
  launch of one block a (program, lag tile, bin split).
* ``LAUNCHES`` counts kernel launches, so a run can show that its main
  path went through the kernel; ``SPLIT_LAUNCHES`` those among them
  whose G rows were shared over a cluster of blocks (2B past one
  block's shared memory, :func:`kernel_plan`), ``PIPELINED_LAUNCHES``
  those that took the pipelined launch.  A launch captured into a CUDA
  graph counts at each replay, not at its capture (``ops/_graph``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError

SUPER = 128       # haystack-extension padding quantum (operand contract)
FUSED_TILE = 512  # lag quantum of fused_span's G width (operand contract)
SPAN_QUANTUM = 4 * SUPER  # quantum of fused_span's staircase span (operand
                          # contract: four Hankel chunks of the JAX kernel)
LAG_TILE = 128    # the CUDA kernel's lag tile (csrc kLagTile)
BIN_PASS = 64     # bins a kernel block ranks per pass (csrc kBinPass)
# The error bound's gamma = BOUND_C * 2B * 2^-23 for stage B's f32 sums
# of 2B exact bf16 products: each addition rounds by at most 2^-23 of
# its result when it truncates (round to nearest: 2^-24), and the tensor
# cores add 16 products and the accumulator at a time, aligned to the
# largest before truncating, which can lose up to 17 such units a step
# of 16 rows; 2 covers both with room.
BOUND_C = 2.0
_SMEM_PER_BLOCK = 232_448  # bytes of shared memory one Hopper block may use
CLUSTER_MAX = 16  # blocks a lag tile may share G's rows over (csrc kClusterMax)
# The split's exchange (csrc kXchgBytes): a bin pass's partial (Rr, Ri),
# 64 bins x 64 lag pairs as float4s, each bin's row padded by 4.
_XCHG_BYTES = 16 * BIN_PASS * (LAG_TILE // 2 + 4)
_GRID_YZ_MAX = 65_535
# The pipelined launch (csrc ``PipeSmem``): two stage-A teams of 8 warps
# a block, each with its G buffer (``LAG_TILE`` lags x 2B rows padded to
# 16, bf16, each 8-lag group of rows 16 bytes past its core matrices) and
# two stage-A buffers, and a ring of 3 weight tiles of 32 bins (64 rows x
# the padded 2B, bf16).
TEAMS = 2
TEAM_WARPS = 8
M_BINS = 32
_PIPE_RING = 3
# Programs per step of the plain version: bounds its (programs, K, lags)
# intermediates.
_PLAIN_CHUNK = 8
# Programs per step of rank_bound_check: its f64 (programs, K, lags)
# intermediates are ~0.7 GB a program at rate3's shape.
_BOUND_CHUNK = 4
_BIG_IDX = 2 ** 30  # "no lag" in the top-2 argmins

LAUNCHES = 0
SPLIT_LAUNCHES = 0
PIPELINED_LAUNCHES = 0


def fused_span(num_blocks: int, sup: int, num_lags: int) -> int:
    """Column span of the per-block staircase (block ``b`` at column
    ``b*sup``); callers size the haystack extension to
    ``span + SUPER - 1`` samples."""
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    span = (num_blocks - 1) * sup + m_pad
    return -(-span // SPAN_QUANTUM) * SPAN_QUANTUM


def block_centers(num_blocks: int, block_len: int, dtype,
                  device) -> torch.Tensor:
    """(B,) block centres ``b D + (D-1)/2``, made on ``device`` in f64
    (exact) and rounded to ``dtype``."""
    return (torch.arange(num_blocks, dtype=torch.float64, device=device)
            * block_len + (block_len - 1) / 2.0).to(dtype)


def stein_synthesis_weights(freqs_hz, sample_rate, num_blocks: int,
                            block_len: int, device=None):
    """(ws1, ws2) = ([Wr | -Wi], [Wi | Wr]), each (K, 2B) f32, with
    ``W[k, b] = exp(-j 2 pi f_k (b D + (D-1)/2) / fs)`` built in f32.
    Nothing is copied to the card: ``-2 pi / fs`` is the f32 quotient of
    the f32 operands, taken in numpy (IEEE, as on the card)."""
    f32 = torch.float32
    if device is None and isinstance(freqs_hz, torch.Tensor):
        device = freqs_hz.device
    scale = float(np.float32(-2.0 * math.pi) / np.float32(sample_rate))
    w = scale * torch.outer(
        torch.as_tensor(freqs_hz, dtype=f32, device=device),
        block_centers(num_blocks, block_len, f32, device))
    wr, wi = torch.cos(w), torch.sin(w)
    return (torch.cat([wr, -wi], dim=1), torch.cat([wi, wr], dim=1))


def stein_rate_synthesis_weights(freqs_hz, rates_hz_per_s, sample_rate,
                                 num_blocks: int, block_len: int,
                                 device=None):
    """(ws1, ws2) with the rate axis folded into synthesis rows (K1 mode
    (f)): ``w[i*K + k, b] = -(2 pi f_k t_b + pi r_i t_b^2)``, ``t_b`` the
    block centres in seconds, rows rate-major, built in f32.  Stage A is
    shared by every (rate, doppler) row; callers fold ``|r|_max * T``
    into the block-length envelope (``models/rate._rate_block_len``)."""
    f32 = torch.float32
    if device is None and isinstance(freqs_hz, torch.Tensor):
        device = freqs_hz.device
    tb = torch.as_tensor(
        np.arange(num_blocks) * block_len + (block_len - 1) / 2.0,
        dtype=f32, device=device) / torch.tensor(sample_rate, dtype=f32,
                                                 device=device)
    f = torch.as_tensor(freqs_hz, dtype=f32, device=device)
    r = torch.as_tensor(rates_hz_per_s, dtype=f32, device=device)
    w = (-(2.0 * math.pi)) * (f[None, :, None] * tb[None, None, :]) \
        - math.pi * (r[:, None, None] * (tb * tb)[None, None, :])
    w = w.reshape(-1, num_blocks)
    wr, wi = torch.cos(w), torch.sin(w)
    return (torch.cat([wr, -wi], dim=1), torch.cat([wi, wr], dim=1))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def program_maps(progs: torch.Tensor, windows: int = 1, share_h: int = 1):
    """The kernel's operand index maps for program ids ``progs``:
    ``i // W`` (into ``lmat``) and ``(i // (S*W))*W + i % W`` (into
    ``h_ext``)."""
    return progs // windows, (progs // (share_h * windows)) * windows \
        + progs % windows


def _stage_a_in_kernel_order(lm, h, sup: int, span: int):
    """(n, 2B, span) f32 staircase ``co`` summed tap by tap in the
    kernel's order (tap e of the real plane, then of the imaginary
    plane).  The operands are bf16-exact, so each product is exact in
    f32 and every partial sum rounds as the kernel's ``fmaf`` chain
    does: the f32 sums, and so their bf16 roundings (G), are the
    kernel's bit for bit.  (Summed in another order, a few G entries
    land one bf16 ulp apart, which moves |R|^2 by up to ~1e-3.)"""
    co = lm.new_zeros(lm.shape[0], lm.shape[1], span)
    for e in range(sup):
        for plane in (0, 1):
            col = plane * sup + e
            co.addcmul_(lm[:, :, col, None], h[:, plane, None, e:e + span])
    return co


def _stage_b_row_by_row(ws1, ws2, g):
    """(n, K, m_pad) ``(ws1 @ G, ws2 @ G)`` summed row by row, one f32
    rounding a row (bf16-exact operands make every product exact): one
    f32 summation order of the many the error bound allows."""
    n, b2, m_pad = g.shape
    rr = g.new_zeros(n, ws1.shape[0], m_pad)
    ri = g.new_zeros(n, ws1.shape[0], m_pad)
    for r in range(b2):
        rr.addcmul_(ws1[None, :, r, None], g[:, None, r, :])
        ri.addcmul_(ws2[None, :, r, None], g[:, None, r, :])
    return rr, ri


def _plain_g(lmat, h_ext, b: int, sup: int, num_lags: int, progs,
             windows: int, share_h: int, emulate_bf16: bool):
    """(n, 2B, m_pad) segment correlations G of the programs ``progs``;
    with ``emulate_bf16`` summed in the kernel's order and rounded to
    bf16, so they are the kernel's bit for bit."""
    li, hi = program_maps(progs, windows, share_h)
    lm, h = lmat[li], h_ext[hi]
    n = len(progs)
    span = h.shape[-1] - (SUPER - 1)
    if emulate_bf16:
        co = _bf16(_stage_a_in_kernel_order(lm, h, sup, span))
    else:
        # Hankel rows: hank[i, plane*sup + e, s] = h[i, plane, e + s].
        hank = h.unfold(2, span, 1)[:, :, :sup, :].reshape(n, 2 * sup, span)
        co = torch.einsum("pbe,pes->pbs", lm, hank)     # (n, 2B, span)
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    # Staircase un-shear: G[i, r, tau] = co[i, r, (r mod b)*sup + tau].
    cols = ((torch.arange(2 * b, device=co.device) % b) * sup)[:, None] \
        + torch.arange(m_pad, device=co.device)[None, :]
    return torch.gather(co, 2, cols.expand(n, -1, -1))


def _valid_lags(progs, m_pad: int, num_lags: int, num_valid):
    """(n, 1, m_pad) mask of the lags each program ranks."""
    dev = progs.device
    if num_valid is None:
        bound = torch.full((len(progs), 1, 1), num_lags, device=dev)
    else:
        nv = torch.as_tensor(num_valid, device=dev).to(torch.int64)
        bound = torch.clamp(nv[progs], max=num_lags)[:, None, None]
    return torch.arange(m_pad, device=dev)[None, None, :] < bound


def _surface_chunk(ws1, ws2, lmat, h_ext, b: int, sup: int, num_lags: int,
                   progs, windows: int, share_h: int, num_valid,
                   emulate_bf16: bool, stage_b_row_by_row: bool):
    """(n, K, m_pad) masked ``|R|^2`` of the programs ``progs``."""
    g = _plain_g(lmat, h_ext, b, sup, num_lags, progs, windows, share_h,
                 emulate_bf16)
    if stage_b_row_by_row:
        rr, ri = _stage_b_row_by_row(ws1, ws2, g)
    else:
        rr = torch.einsum("kb,pbm->pkm", ws1, g)
        ri = torch.einsum("kb,pbm->pkm", ws2, g)
    mag2 = rr * rr + ri * ri
    valid = _valid_lags(progs, g.shape[-1], num_lags, num_valid)
    return torch.where(valid, mag2, torch.full_like(mag2, -1.0))


def stage_b_error_bound(ws1, ws2, g):
    """The f64 reference of stage B on a bf16 G, and the error bound of
    each |R|^2 the kernel may return: ``(v, e)``, each (n, K, lags) f64.

    ``v = Rr^2 + Ri^2`` with ``Rr = ws1 @ G``, ``Ri = ws2 @ G`` in f64
    (exact for bf16 operands at these sizes), and ``e = 2 gamma (|Rr| A_r
    + |Ri| A_i) + gamma^2 (A_r^2 + A_i^2) + 2^-22 v`` with ``A_r = |ws1|
    @ |G|``, ``A_i = |ws2| @ |G|`` and ``gamma = BOUND_C * 2B * 2^-23``: any
    f32 summation of the 2B exact products moves ``Rr`` by at most
    ``gamma A_r`` (so ``Rr^2`` by ``2 gamma |Rr| A_r + gamma^2 A_r^2``),
    and |R|^2's two products and one sum in f32 add at most ``2^-22 v``.
    ``ws1``, ``ws2`` (K, 2B) and ``g`` (n, 2B, lags) hold bf16 values."""
    w1, w2, gd = ws1.double(), ws2.double(), g.double()
    ga = gd.abs()
    rr = torch.einsum("kb,pbm->pkm", w1, gd)
    ri = torch.einsum("kb,pbm->pkm", w2, gd)
    ar = torch.einsum("kb,pbm->pkm", w1.abs(), ga)
    ai = torch.einsum("kb,pbm->pkm", w2.abs(), ga)
    gamma = BOUND_C * g.shape[1] * 2.0 ** -23
    v = rr * rr + ri * ri
    e = (2.0 * gamma * (rr.abs() * ar + ri.abs() * ai)
         + gamma * gamma * (ar * ar + ai * ai) + 2.0 ** -22 * v)
    return v, e


def _ratio(num, den):
    """max of num / den, where den is 0 only for exact cells (masked
    lags, an all-zero G): there any difference is infinitely off."""
    r = torch.where(den > 0, num / den.clamp(min=1e-300),
                    torch.where(num == 0, 0.0, math.inf))
    return float(r.max()) if r.numel() else 0.0


def _lowest_argmax(x):
    """(max, lowest lag attaining it) over the last axis."""
    m = x.amax(dim=-1, keepdim=True)
    lag = torch.arange(x.shape[-1], device=x.device)
    return m[..., 0], torch.where(x >= m, lag, _BIG_IDX).amin(dim=-1)


def _slot_check(v, e, kv, ki):
    """One slot of a kernel answer (values ``kv``, lags ``ki``, each (n,
    K)) against the f64 surface ``v`` and bound ``e`` (n, K, lags):
    (largest |value - v*(lag)| / e(lag), largest (v*max - v*(lag)) /
    (e(lag) + e(f64 argmax)), largest |value - v*(lag)|)."""
    ki = ki.long().clamp(0, v.shape[-1] - 1)
    vk = torch.gather(v, 2, ki[..., None])[..., 0]
    ek = torch.gather(e, 2, ki[..., None])[..., 0]
    vmax, amax = _lowest_argmax(v)
    emax = torch.gather(e, 2, amax[..., None])[..., 0]
    err = (kv.double() - vk).abs()
    return (_ratio(err, ek), _ratio(vmax - vk, ek + emax),
            float(err.max()) if err.numel() else 0.0)


def rank_bound_check(got, ws1, ws2, lmat, h_ext, b: int, sup: int,
                     num_lags: int, windows: int = 1, share_h: int = 1,
                     num_valid=None, sep=None) -> dict:
    """The kernel's answer ``got`` ((K, P_eff) values and lags; with
    ``sep`` the top-2 mode's four fields) against :func:`stage_b_error_bound`
    on the plain version's G (the kernel's bit for bit), ``_BOUND_CHUNK``
    programs at a time.  Masked lags must read -1.0 exactly.  Returns
    ``ratio`` (largest |err| / e over the slots), ``max_abs_err`` (the
    largest |err| itself), ``lag_ratio`` (the
    largest gap between the f64 max and v* at the kernel's lag, over the
    sum of their bounds), ``lags_off_f32`` (lags that differ from the
    plain f32 surface's, which may be non-zero only at near-ties), ``n``
    (slots checked) and ``ok`` (both ratios at most 1, every lag in
    range, slot 2 outside the window or the (-1.0, 0) sentinel)."""
    ws1, ws2, lmat, h_ext = map(_bf16, (ws1, ws2, lmat, h_ext))
    p_eff = lmat.shape[0] * windows
    out = {"ratio": 0.0, "lag_ratio": 0.0, "max_abs_err": 0.0,
           "lags_off_f32": 0, "n": 0, "ok": True}
    for p0 in range(0, p_eff, _BOUND_CHUNK):
        progs = torch.arange(p0, min(p0 + _BOUND_CHUNK, p_eff),
                             device=lmat.device)
        g = _plain_g(lmat, h_ext, b, sup, num_lags, progs, windows, share_h,
                     True)
        v, e = stage_b_error_bound(ws1, ws2, g)
        valid = _valid_lags(progs, g.shape[-1], num_lags, num_valid)
        v = torch.where(valid, v, -1.0)
        e = torch.where(valid, e, 0.0)
        rr = torch.einsum("kb,pbm->pkm", ws1, g)
        ri = torch.einsum("kb,pbm->pkm", ws2, g)
        f32 = torch.where(valid, rr * rr + ri * ri, -1.0)
        fields = [t[:, p0:p0 + len(progs)].T for t in got]
        kv, ki = fields[0], fields[1].long()
        slots = [(v, e, kv, ki, _lowest_argmax(f32)[1])]
        in_range = bool(((ki >= 0) & (ki < num_lags)).all())
        if sep is not None:
            kv2, ki2 = fields[2], fields[3].long()
            lag = torch.arange(v.shape[-1], device=v.device)
            outside = (lag - ki[..., None]).abs() > sep
            v2 = torch.where(outside, v, -1.0)
            e2 = torch.where(outside, e, 0.0)
            f32_2 = top2_separated(f32, sep)[3]
            none = kv2 == -1.0
            # No lag outside the window: slot 2 is the (-1.0, 0) sentinel.
            in_range &= bool(((ki2 >= 0) & (ki2 < num_lags)).all()
                             and (ki2[none] == 0).all()
                             and (v2.amax(dim=-1)[none] == -1.0).all())
            slots.append((v2, e2, kv2, ki2, f32_2))
        for sv, se, skv, ski, fl in slots:
            r, lr, err = _slot_check(sv, se, skv, ski)
            out["ratio"] = max(out["ratio"], r)
            out["lag_ratio"] = max(out["lag_ratio"], lr)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["lags_off_f32"] += int((ski != fl.long()).sum())
            out["n"] += ski.numel()
        out["ok"] &= in_range
    out["ok"] &= out["ratio"] <= 1.0 and out["lag_ratio"] <= 1.0
    return out


def coarse_surface_plain(ws1, ws2, lmat, h_ext, b: int, sup: int,
                         num_lags: int, emulate_bf16: bool = False,
                         windows: int = 1, share_h: int = 1,
                         num_valid=None):
    """(P_eff, K, m_pad) masked ``|R|^2`` of the coarse rank, in plain
    PyTorch: lags at or past ``num_lags`` (or past ``num_valid[i]`` when
    given, capped at ``num_lags``) read -1.0.  ``emulate_bf16`` applies
    the kernel's roundings, sums stage A in its order (G is the
    kernel's bit for bit) and stage B row by row."""
    if emulate_bf16:
        ws1, ws2, lmat, h_ext = map(_bf16, (ws1, ws2, lmat, h_ext))
    progs = torch.arange(lmat.shape[0] * windows, device=lmat.device)
    return _surface_chunk(ws1, ws2, lmat, h_ext, b, sup, num_lags, progs,
                          windows, share_h, num_valid, emulate_bf16,
                          emulate_bf16)


def top2_separated(mag2: torch.Tensor, sep: int):
    """Per row of a (..., lags) masked surface: (max, lowest lag) and the
    max over lags with ``|lag - lag1| > sep`` with its lowest lag — the
    ``want_top2`` branch of ``_coarse_rank_xla``.  With no second lag
    the masked row is all -1.0, so slot 2 reads (-1.0, 0).  Returns four
    (...) tensors: values f32, lags int32."""
    lag = torch.arange(mag2.shape[-1], device=mag2.device)
    m1 = torch.amax(mag2, dim=-1, keepdim=True)
    a1 = torch.amin(torch.where(mag2 >= m1, lag, _BIG_IDX), dim=-1,
                    keepdim=True)
    masked = torch.where((lag - a1).abs() <= sep, -1.0, mag2)
    m2 = torch.amax(masked, dim=-1, keepdim=True)
    a2 = torch.amin(torch.where(masked >= m2, lag, _BIG_IDX), dim=-1,
                    keepdim=True)
    a1, a2 = (torch.where(a == _BIG_IDX, 0, a).to(torch.int32)
              for a in (a1, a2))
    return m1[..., 0], a1[..., 0], m2[..., 0], a2[..., 0]


def coarse_rank_plain(ws1, ws2, lmat, h_ext, b: int, sup: int,
                      num_lags: int, emulate_bf16: bool = False,
                      windows: int = 1, share_h: int = 1, num_valid=None,
                      want_top2: bool = False, sep: int = 0):
    """Plain PyTorch version of the kernel (port of ``_coarse_rank_xla``
    with the kernel's index maps): ((K, P_eff) f32 values, (K, P_eff)
    int32 lowest-argmax lags), ``_PLAIN_CHUNK`` programs at a time;
    ``want_top2`` adds the slot-2 values and lags of
    :func:`top2_separated`."""
    if emulate_bf16:
        ws1, ws2, lmat, h_ext = map(_bf16, (ws1, ws2, lmat, h_ext))
    p_eff = lmat.shape[0] * windows
    fields = []
    for p0 in range(0, p_eff, _PLAIN_CHUNK):
        progs = torch.arange(p0, min(p0 + _PLAIN_CHUNK, p_eff),
                             device=lmat.device)
        mag2 = _surface_chunk(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                              progs, windows, share_h, num_valid,
                              emulate_bf16, False)
        if want_top2:
            fields.append(top2_separated(mag2, sep))
        else:
            v, i = torch.max(mag2, dim=-1)      # first maximum on ties
            fields.append((v, i.to(torch.int32)))
    return tuple(torch.cat(f).T.contiguous() for f in zip(*fields))


def _check_operands(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags,
                    windows, share_h, num_valid):
    if not all(t.is_floating_point() for t in (ws1, ws2, lmat, h_ext)):
        raise TypeError("fused_stein_rank takes real floating operands "
                        "(split-complex planes)")
    if windows < 1 or share_h < 1:
        raise ValueError(f"windows ({windows}) and share_h ({share_h}) "
                         "must be at least 1")
    k, b2 = ws1.shape
    if ws2.shape != ws1.shape:
        raise ValueError(f"ws2 shape {tuple(ws2.shape)} != ws1 "
                         f"{tuple(ws1.shape)}")
    if b2 != 2 * num_blocks or lmat.shape[1] != b2:
        raise ValueError(f"weights ({b2} cols) / operator ({lmat.shape[1]} "
                         f"rows) do not match 2*num_blocks = {2 * num_blocks}")
    if lmat.shape[2] != 2 * sup:
        raise ValueError(
            f"operator width {lmat.shape[2]} != 2*block_len {2 * sup}")
    if lmat.shape[0] * windows != h_ext.shape[0] * share_h:
        raise ValueError(
            f"{lmat.shape[0]} operators x {windows} windows != "
            f"{h_ext.shape[0]} h_ext slices x {share_h} bands")
    span = fused_span(num_blocks, sup, num_lags)
    if tuple(h_ext.shape[1:]) != (2, span + SUPER - 1):
        raise ValueError(f"h_ext shape {tuple(h_ext.shape)} != "
                         f"(*, 2, {span + SUPER - 1})")
    p_eff = lmat.shape[0] * windows
    if num_valid is not None and tuple(num_valid.shape) != (p_eff,):
        raise ValueError(f"num_valid shape {tuple(num_valid.shape)} != "
                         f"({p_eff},)")


def fused_stein_rank(ws1, ws2, lmat, h_ext, num_blocks: int, sup: int,
                     num_lags: int, want_idxs: bool = True,
                     windows: int = 1, share_h: int = 1, num_valid=None,
                     want_top2: bool = False, sep: int = 0):
    """Per-(bin, program) (max |R|^2, lowest arg lag) of the Stein
    coarse rank.

    ``ws1``/``ws2``: (K, 2B) synthesis weights; ``lmat``: (P*S, 2B,
    2*sup) needle-tap operators, one per (pair, band); ``h_ext``:
    (P*W, 2, span+127) haystack extensions, one per (pair, window) (see
    ``models/batched_stein``); ``num_valid``: optional (P_eff,) integer
    per-program lag bound (numpy or a tensor).  Returns ((K, P_eff) f32,
    (K, P_eff) int32) with window-local lags; the lags are zeros when
    ``want_idxs=False``.  ``want_top2=True`` returns ``(vals, idxs,
    vals2, idxs2)``: slot 2 is the strongest lag more than ``sep`` from
    slot 1's, (-1.0, 0) when there is none (:func:`top2_separated`).

    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run :func:`coarse_rank_plain` with the kernel's bf16
    roundings.
    """
    devices = {t.device for t in (ws1, ws2, lmat, h_ext)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if num_valid is not None:
        num_valid = torch.as_tensor(num_valid, dtype=torch.int32,
                                    device=device)
    _check_operands(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags,
                    windows, share_h, num_valid)
    if device.type == "cuda":
        out = _launch(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags,
                      windows, share_h, num_valid,
                      sep if want_top2 else None)
    elif device.type == "cpu":
        out = coarse_rank_plain(ws1, ws2, lmat, h_ext, num_blocks, sup,
                                num_lags, emulate_bf16=True,
                                windows=windows, share_h=share_h,
                                num_valid=num_valid, want_top2=want_top2,
                                sep=sep)
    else:
        raise ValueError(f"fused_stein_rank: unsupported device {device}")
    if want_top2:
        return out
    vals, idxs = out
    if not want_idxs:
        idxs = torch.zeros_like(idxs)
    return vals, idxs


def _tile_smem_bytes(rows: int, sup: int, split: bool = False) -> int:
    """Dynamic shared memory of the kernel's tile block (csrc
    ``TileSmem``): the bf16 G tile, ``LAG_TILE`` lags x (its rows padded
    to 16, + 8), and two stage-A buffers, each the skewed haystack window
    of 8 segments in both planes and their 8 x 2 tap rows, f32; with
    ``split`` the exchange overlays the buffers, so the larger counts."""
    rows_p = -(-rows // 16) * 16
    return LAG_TILE * (rows_p + 8) * 2 + (
        max(_stage_a_bytes(sup), _XCHG_BYTES) if split
        else _stage_a_bytes(sup))


def _stage_a_bytes(sup: int, chunk: int = 8) -> int:
    """Stage A's two buffers (csrc ``TileSmem``): each the skewed
    haystack window of a chunk of segments (8 in a tile block) in both
    planes and their chunk x 2 tap rows, f32."""
    last = chunk * sup + LAG_TILE - 2
    hay = -(-(last + (last >> 2) + 1) // 4) * 4
    return 2 * (2 * hay + 4 * chunk * sup) * 4


def _pipe_smem_bytes(b2: int, sup: int) -> int:
    """Dynamic shared memory of a pipelined block (csrc ``PipeSmem``):
    128 bytes of barriers, the weight ring, the teams' G buffers and
    their stage-A buffers."""
    kp = -(-b2 // 16) * 16
    return (128 + _PIPE_RING * 64 * kp * 2
            + TEAMS * (LAG_TILE // 8 * (kp // 8 * 128 + 16)
                       + _stage_a_bytes(sup, TEAM_WARPS)))


def pipelined(b2: int, sup: int, want_top2: bool, cluster: int) -> bool:
    """Whether K1 takes its pipelined launch at 2B rows, block length
    ``sup``, the top-2 mode or not and ``cluster`` blocks a lag tile
    (:func:`kernel_plan`): only in the atomic-key modes (not top-2, whose
    recompute must repeat the tile pass's |R|^2 with the tile launch's
    device functions), at one block a tile, and where two G tiles, the
    teams' stage-A buffers and the weight ring fit a block's shared
    memory (2B <= 192 at D = 64; not the stream's 2B = 512)."""
    return (not want_top2 and cluster == 1
            and _pipe_smem_bytes(b2, sup) <= _SMEM_PER_BLOCK)


class KernelPlan(NamedTuple):
    """How K1 shares a lag tile's G rows (csrc ``row_plan``): ``cluster``
    blocks a tile (a thread-block cluster when more than 1), each holding
    ``rows`` rows of G (its ``seg`` segments' two rows each, padded to
    16), in ``smem`` bytes of shared memory a block."""

    cluster: int
    rows: int
    smem: int
    seg: int


def kernel_plan(b2: int, sup: int):
    """The fewest blocks a lag tile whose G rows, stage-A buffers (and,
    split, the exchange) fit a block's shared memory: a
    :class:`KernelPlan`, or None past ``CLUSTER_MAX`` blocks."""
    b = b2 // 2
    smem = _tile_smem_bytes(b2, sup)
    if smem <= _SMEM_PER_BLOCK:
        return KernelPlan(1, -(-b2 // 16) * 16, smem, b)
    for c in range(2, CLUSTER_MAX + 1):
        seg = -(-b // c)
        smem = _tile_smem_bytes(2 * seg, sup, split=True)
        if smem <= _SMEM_PER_BLOCK:
            return KernelPlan(c, -(-2 * seg // 16) * 16, smem, seg)
    return None


def row_ceiling(sup: int) -> int:
    """The most rows 2B the kernel takes at block length ``sup``: each of
    ``CLUSTER_MAX`` blocks holding the most segments that fit."""
    seg = 0
    while _tile_smem_bytes(2 * (seg + 1), sup, split=True) <= _SMEM_PER_BLOCK:
        seg += 1
    return 2 * CLUSTER_MAX * seg


def check_kernel_shape(b2: int, sup: int) -> KernelPlan:
    """The kernel's plan for a (2B rows, block length) shape
    (:func:`kernel_plan`), or the typed error of a shape it refuses —
    ``EligibilityError`` for a block length not a multiple of 4,
    ``VmemBudgetError`` past :func:`row_ceiling` (16 blocks' shared
    memory)."""
    if sup % 4:
        raise EligibilityError(f"fused Stein kernel: block_len {sup} is not "
                               "a multiple of 4")
    plan = kernel_plan(b2, sup)
    if plan is None:
        raise VmemBudgetError(
            f"fused Stein kernel: 2B = {b2} rows at block_len {sup} pass its "
            f"ceiling of {row_ceiling(sup)} rows (G's rows shared over "
            f"{CLUSTER_MAX} blocks' shared memory); use fused=False")
    return plan


def kernel_occupancy(b2: int, sup: int) -> dict:
    """The tile launch's residency on the current card (needs the
    kernel library and a card): blocks a SM and, when G's rows are split,
    the clusters the card holds at once (``cudaOccupancyMaxActiveClusters``;
    -1 for one block a tile)."""
    from caf_cookoff_tpu_torch.ops import _build

    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.load_library().caf_fused_stein_occupancy(
        b2, sup, ctypes.byref(blocks), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"fused Stein occupancy query failed ({rc})")
    return {"blocks_per_sm": blocks.value, "max_active_clusters":
            clusters.value}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bins_per_split(k: int, tiles: int, sms: int) -> int:
    """Bins per block (a multiple of ``BIN_PASS``): all of them unless
    the blocks of programs x lag tiles (``tiles``, a tile's cluster
    counted block by block) leave SMs idle, then the fewest splits that
    give every SM a block — each split repeats stage A for its tile."""
    passes = -(-k // BIN_PASS)
    splits = min(passes, max(1, -(-sms // tiles)))
    return -(-passes // splits) * BIN_PASS


def _pipe_geometry(k: int, tiles: int, sms: int):
    """The pipelined launch's (bins per split, persistent blocks) for K
    bins and ``tiles`` (program, lag tile)s on ``sms`` SMs: the bins
    split (:func:`_bins_per_split`) where the tiles leave SMs idle, and a
    block a SM takes ~items / blocks consecutive work items (program, lag
    tile, bin split), one G tile at a time."""
    per_split = _bins_per_split(k, tiles, sms)
    items = tiles * -(-k // per_split)
    return per_split, min(sms, items)


def _launch(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags, windows,
            share_h, num_valid, sep):
    """Launch the kernel; ``sep`` is None without the top-2 mode."""
    global LAUNCHES, SPLIT_LAUNCHES, PIPELINED_LAUNCHES
    from caf_cookoff_tpu_torch.ops import _build

    b2 = lmat.shape[1]
    p_eff = lmat.shape[0] * windows
    k = ws1.shape[0]
    plan = check_kernel_shape(b2, sup)
    m_pad = -(-num_lags // LAG_TILE) * LAG_TILE
    h_len = h_ext.shape[-1]
    if h_len < (num_blocks - 1) * sup + m_pad + sup - 1:
        raise ValueError(f"h_ext length {h_len} too short for the kernel")
    lib = _build.load_library()
    c_cluster, c_rows = ctypes.c_int(0), ctypes.c_int(0)
    c_smem = lib.caf_fused_stein_plan(b2, sup, ctypes.byref(c_cluster),
                                      ctypes.byref(c_rows))
    if (lib.caf_fused_stein_lag_tile(), lib.caf_fused_stein_bin_pass(),
            c_cluster.value, c_rows.value, c_smem,
            lib.caf_fused_stein_pipe_smem(b2, sup)) != (
                LAG_TILE, BIN_PASS, plan.cluster, plan.rows, plan.smem,
                _pipe_smem_bytes(b2, sup)):
        raise RuntimeError("csrc tile plan disagrees with the wrapper's")
    dev = ws1.device
    f32 = torch.float32
    ws1, ws2, lmat, h = (t.to(f32).contiguous()
                         for t in (ws1, ws2, lmat, h_ext))
    n_tiles = m_pad // LAG_TILE
    sms = _sm_count(dev)
    pipe = pipelined(b2, sup, sep is not None, plan.cluster)
    # The kernel's first launch writes the operands' bf16 roundings here:
    # the weights as 32-bin m-tiles in the warpgroup's layout when
    # pipelined, else in the ranks' row order when G is split.
    if pipe:
        ws_b = torch.empty((-(-k // M_BINS), 64, -(-b2 // 16) * 16),
                           dtype=torch.bfloat16, device=dev)
        per_split, pipe_blocks = _pipe_geometry(k, p_eff * n_tiles, sms)
    else:
        ld = b2 if plan.cluster == 1 else plan.cluster * plan.rows
        ws_b = torch.empty((2, k, ld), dtype=torch.bfloat16, device=dev)
        # The program axis (grid z) goes out in chunks of 65535 programs;
        # a lag tile takes plan.cluster blocks.
        per_split = _bins_per_split(
            k, min(p_eff, _GRID_YZ_MAX) * n_tiles * plan.cluster, sms)
        pipe_blocks = 0
    lmat_r, h_r = torch.empty_like(lmat), torch.empty_like(h)
    keys = torch.empty((k, p_eff), dtype=torch.int64, device=dev)
    part_val = part_lag = None
    if sep is not None:
        part_val = torch.empty((p_eff, k, n_tiles), dtype=f32, device=dev)
        part_lag = torch.empty((p_eff, k, n_tiles), dtype=torch.int32,
                               device=dev)
    outs = [torch.empty((k, p_eff), dtype=dt, device=dev)
            for dt in (f32, torch.int32) * (1 if sep is None else 2)]
    top2 = outs[2:] if sep is not None else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The launches go to the operands' card; the caller's current card
    # is restored afterwards.
    with torch.cuda.device(dev):
        rc = lib.caf_fused_stein_rank(
            *(t.data_ptr() for t in (ws1, ws2, lmat, h, ws_b, lmat_r, h_r)),
            ptr(None if num_valid is None else num_valid.contiguous()),
            keys.data_ptr(), ptr(part_val), ptr(part_lag),
            outs[0].data_ptr(), outs[1].data_ptr(), *map(ptr, top2),
            p_eff, k, num_blocks, sup, h_len, num_lags, m_pad, windows,
            share_h,
            # |lag - lag1| <= sep means the same for every sep >= m_pad.
            0 if sep is None else min(int(sep), m_pad), per_split,
            pipe_blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused Stein kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    LAUNCHES += 1
    if plan.cluster > 1:
        SPLIT_LAUNCHES += 1
    if pipe:
        PIPELINED_LAUNCHES += 1
    return tuple(outs)
