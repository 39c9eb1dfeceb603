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
  B row by row in the kernel's order, so every |R|^2 is the kernel's
  bit for bit.
* ``want_top2=True`` (K1 mode (e)) adds, per (program, bin), the
  strongest lag more than ``sep`` from the first (:func:`top2_separated`:
  value -1.0 and lag 0 when there is none) — exact for any separation
  past ``sep``, where the TPU kernel's tile merge guarantees only past
  ``2*sep``.
* ``LAUNCHES`` counts kernel launches, so a run can show that its main
  path went through the kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from caf_cookoff_tpu_torch.errors import VmemBudgetError

SUPER = 128       # haystack-extension padding quantum (operand contract)
FUSED_TILE = 512  # lag quantum of fused_span's G width (operand contract)
SPAN_QUANTUM = 4 * SUPER  # quantum of fused_span's staircase span (operand
                          # contract: four Hankel chunks of the JAX kernel)
LAG_TILE = 128    # the CUDA kernel's lag tile (csrc kLagTile)
_SMEM_PER_BLOCK = 232_448  # bytes of shared memory one Hopper block may use
_GRID_YZ_MAX = 65_535
# Programs per step of the plain version: bounds its (programs, K, lags)
# intermediates.
_PLAIN_CHUNK = 8
_BIG_IDX = 2 ** 30  # "no lag" in the top-2 argmins

LAUNCHES = 0


def fused_span(num_blocks: int, sup: int, num_lags: int) -> int:
    """Column span of the per-block staircase (block ``b`` at column
    ``b*sup``); callers size the haystack extension to
    ``span + SUPER - 1`` samples."""
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    span = (num_blocks - 1) * sup + m_pad
    return -(-span // SPAN_QUANTUM) * SPAN_QUANTUM


def stein_synthesis_weights(freqs_hz, sample_rate, num_blocks: int,
                            block_len: int, device=None):
    """(ws1, ws2) = ([Wr | -Wi], [Wi | Wr]), each (K, 2B) f32, with
    ``W[k, b] = exp(-j 2 pi f_k (b D + (D-1)/2) / fs)`` built in f32."""
    f32 = torch.float32
    if device is None and isinstance(freqs_hz, torch.Tensor):
        device = freqs_hz.device
    centers = torch.as_tensor(
        np.arange(num_blocks) * block_len + (block_len - 1) / 2.0,
        dtype=f32, device=device)
    scale = (torch.tensor(-2.0 * math.pi, dtype=f32, device=device)
             / torch.tensor(sample_rate, dtype=f32, device=device))
    w = scale * torch.outer(
        torch.as_tensor(freqs_hz, dtype=f32, device=device), centers)
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


def _stage_b_in_kernel_order(ws1, ws2, g):
    """(n, K, m_pad) ``(ws1 @ G, ws2 @ G)`` summed row by row in the
    kernel's order.  With bf16-exact operands every product is exact in
    f32, so each partial sum rounds as the kernel's ``fmaf`` chain does."""
    n, b2, m_pad = g.shape
    rr = g.new_zeros(n, ws1.shape[0], m_pad)
    ri = g.new_zeros(n, ws1.shape[0], m_pad)
    for r in range(b2):
        rr.addcmul_(ws1[None, :, r, None], g[:, None, r, :])
        ri.addcmul_(ws2[None, :, r, None], g[:, None, r, :])
    return rr, ri


def _surface_chunk(ws1, ws2, lmat, h_ext, b: int, sup: int, num_lags: int,
                   progs, windows: int, share_h: int, num_valid,
                   emulate_bf16: bool, stage_b_in_kernel_order: bool):
    """(n, K, m_pad) masked ``|R|^2`` of the programs ``progs``."""
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
    g = torch.gather(co, 2, cols.expand(n, -1, -1))     # (n, 2B, m_pad)
    if stage_b_in_kernel_order:
        rr, ri = _stage_b_in_kernel_order(ws1, ws2, g)
    else:
        rr = torch.einsum("kb,pbm->pkm", ws1, g)
        ri = torch.einsum("kb,pbm->pkm", ws2, g)
    mag2 = rr * rr + ri * ri
    if num_valid is None:
        bound = torch.full((n, 1, 1), num_lags, device=mag2.device)
    else:
        nv = torch.as_tensor(num_valid, device=mag2.device).to(torch.int64)
        bound = torch.clamp(nv[progs], max=num_lags)[:, None, None]
    valid = torch.arange(m_pad, device=mag2.device)[None, None, :] < bound
    return torch.where(valid, mag2, torch.full_like(mag2, -1.0))


def coarse_surface_plain(ws1, ws2, lmat, h_ext, b: int, sup: int,
                         num_lags: int, emulate_bf16: bool = False,
                         windows: int = 1, share_h: int = 1,
                         num_valid=None):
    """(P_eff, K, m_pad) masked ``|R|^2`` of the coarse rank, in plain
    PyTorch: lags at or past ``num_lags`` (or past ``num_valid[i]`` when
    given, capped at ``num_lags``) read -1.0.  ``emulate_bf16`` sums
    stage B in the kernel's order too, so the surface is the kernel's
    bit for bit."""
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


def _stage_a_smem_bytes(sup: int) -> int:
    """Dynamic shared memory of the kernel's stage-A block: two haystack
    windows of ``LAG_TILE + sup - 1`` samples and two tap rows of
    ``2*sup``, in f32."""
    return (2 * (LAG_TILE + sup - 1) + 4 * sup) * 4


def _launch(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags, windows,
            share_h, num_valid, sep):
    """Launch the kernel; ``sep`` is None without the top-2 mode."""
    global LAUNCHES
    from caf_cookoff_tpu_torch.ops import _build

    b2 = lmat.shape[1]
    p_eff = lmat.shape[0] * windows
    k = ws1.shape[0]
    if _stage_a_smem_bytes(sup) > _SMEM_PER_BLOCK:
        raise VmemBudgetError(
            f"fused Stein kernel: block_len {sup} needs "
            f"{_stage_a_smem_bytes(sup)} B of shared memory per block, "
            f"past the card's {_SMEM_PER_BLOCK} B; use the unfused path")
    # The library tiles the program axis (grid z) across launches.
    if max(num_blocks, -(-k // 64)) > _GRID_YZ_MAX:
        raise ValueError(f"fused Stein kernel: grid too large "
                         f"(B={num_blocks}, K={k})")
    m_pad = -(-num_lags // LAG_TILE) * LAG_TILE
    h_len = h_ext.shape[-1]
    if h_len < (num_blocks - 1) * sup + m_pad + sup - 1:
        raise ValueError(f"h_ext length {h_len} too short for the kernel")
    lib = _build.load_library()
    if lib.caf_fused_stein_lag_tile() != LAG_TILE:
        raise RuntimeError("csrc lag tile disagrees with LAG_TILE")
    dev = ws1.device
    bf16 = torch.bfloat16
    ws1b = ws1.to(bf16).contiguous()
    ws2b = ws2.to(bf16).contiguous()
    lmatb = lmat.to(bf16).contiguous()
    h = h_ext.to(torch.float32).contiguous()
    n_tiles = m_pad // LAG_TILE
    g = torch.empty((p_eff, b2, m_pad), dtype=bf16, device=dev)
    part_val = torch.empty((p_eff, k, n_tiles), dtype=torch.float32,
                           device=dev)
    part_lag = torch.empty((p_eff, k, n_tiles), dtype=torch.int32,
                           device=dev)
    outs = [torch.empty((k, p_eff), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32) * (1 if sep is None
                                                       else 2)]
    top2 = outs[2:] if sep is not None else (None, None)
    # The launches go to the operands' card; the caller's current card
    # is restored afterwards.
    with torch.cuda.device(dev):
        rc = lib.caf_fused_stein_rank(
            ws1b.data_ptr(), ws2b.data_ptr(), lmatb.data_ptr(), h.data_ptr(),
            None if num_valid is None else num_valid.contiguous().data_ptr(),
            g.data_ptr(), part_val.data_ptr(), part_lag.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            *(None if t is None else t.data_ptr() for t in top2),
            p_eff, k, num_blocks, sup, h_len, num_lags, m_pad, windows,
            share_h,
            # |lag - lag1| <= sep means the same for every sep >= m_pad.
            0 if sep is None else min(int(sep), m_pad),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused Stein kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    LAUNCHES += 1
    return tuple(outs)
