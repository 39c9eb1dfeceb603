"""Fused Stein coarse rank: the CUDA kernel's wrapper and its plain
PyTorch version.

Per (pair, doppler bin) the rank is the max over lags of
``|ws1 @ G|^2 + |ws2 @ G|^2`` and the lowest lag attaining it, where
``G`` are the needle's segment correlations built from a Hankel view of
the haystack extension (stage A) — the contract of the JAX package's
``fused_stein_rank`` and its XLA twin ``_coarse_rank_xla``.  Operand
shapes are the JAX package's, so the same numpy operands feed both.

* :func:`fused_stein_rank` launches ``csrc/fused_stein.cu`` for CUDA
  tensors (or raises) and runs the plain version for CPU tensors.
* :func:`coarse_rank_plain` is that plain version; ``emulate_bf16=True``
  applies the kernel's roundings (inputs and G to bf16, f32 sums).
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def coarse_surface_plain(ws1, ws2, lmat, h_ext, b: int, sup: int,
                         num_lags: int, emulate_bf16: bool = False):
    """(P, K, m_pad) masked ``|R|^2`` of the coarse rank (lags at or past
    ``num_lags`` read -1.0), in plain PyTorch."""
    if emulate_bf16:
        ws1, ws2, lmat, h_ext = map(_bf16, (ws1, ws2, lmat, h_ext))
    p = h_ext.shape[0]
    span = h_ext.shape[-1] - (SUPER - 1)
    # Hankel rows: hank[p, plane*sup + e, s] = h_ext[p, plane, e + s].
    hank = h_ext.unfold(2, span, 1)[:, :, :sup, :].reshape(p, 2 * sup, span)
    co = torch.einsum("pbe,pes->pbs", lmat, hank)       # (P, 2B, span)
    if emulate_bf16:
        co = _bf16(co)
    m_pad = -(-num_lags // FUSED_TILE) * FUSED_TILE
    # Staircase un-shear: G[p, r, tau] = co[p, r, (r mod b)*sup + tau].
    cols = ((torch.arange(2 * b, device=co.device) % b) * sup)[:, None] \
        + torch.arange(m_pad, device=co.device)[None, :]
    g = torch.gather(co, 2, cols.expand(p, -1, -1))     # (P, 2B, m_pad)
    rr = torch.einsum("kb,pbm->pkm", ws1, g)
    ri = torch.einsum("kb,pbm->pkm", ws2, g)
    mag2 = rr * rr + ri * ri
    valid = torch.arange(m_pad, device=mag2.device) < num_lags
    return torch.where(valid, mag2, torch.full_like(mag2, -1.0))


def coarse_rank_plain(ws1, ws2, lmat, h_ext, b: int, sup: int,
                      num_lags: int, emulate_bf16: bool = False):
    """Plain PyTorch version of the kernel (port of ``_coarse_rank_xla``):
    ((K, P) f32 values, (K, P) int32 lowest-argmax lags)."""
    mag2 = coarse_surface_plain(ws1, ws2, lmat, h_ext, b, sup, num_lags,
                                emulate_bf16)
    vals, idxs = torch.max(mag2, dim=-1)   # first maximum on ties
    return vals.T.contiguous(), idxs.to(torch.int32).T.contiguous()


def _check_operands(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags):
    if not all(t.is_floating_point() for t in (ws1, ws2, lmat, h_ext)):
        raise TypeError("fused_stein_rank takes real floating operands "
                        "(split-complex planes)")
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
    span = fused_span(num_blocks, sup, num_lags)
    if h_ext.shape[0] != lmat.shape[0] or \
            tuple(h_ext.shape[1:]) != (2, span + SUPER - 1):
        raise ValueError(f"h_ext shape {tuple(h_ext.shape)} != "
                         f"({lmat.shape[0]}, 2, {span + SUPER - 1})")


def fused_stein_rank(ws1, ws2, lmat, h_ext, num_blocks: int, sup: int,
                     num_lags: int, want_idxs: bool = True,
                     windows: int = 1, share_h: int = 1, num_valid=None,
                     want_top2: bool = False, sep: int = 0):
    """Per-(bin, pair) (max |R|^2, lowest arg lag) of the Stein coarse rank.

    ``ws1``/``ws2``: (K, 2B) synthesis weights; ``lmat``: (P, 2B, 2*sup)
    needle-tap operator; ``h_ext``: (P, 2, span+127) haystack extensions
    (see ``models/batched_stein``).  Returns ((K, P) f32, (K, P) int32);
    the lags are zeros when ``want_idxs=False``.

    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run :func:`coarse_rank_plain` with the kernel's bf16
    roundings.
    """
    if windows != 1 or share_h != 1 or num_valid is not None or want_top2:
        raise NotImplementedError(
            "fused_stein_rank: windows/num_valid (ROADMAP Queue 2 K1(d)), "
            "share_h bands (K1(c)) and want_top2 (K1(e)) are not ported yet")
    _check_operands(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags)
    devices = {t.device for t in (ws1, ws2, lmat, h_ext)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    device = devices.pop()
    if device.type == "cuda":
        vals, idxs = _launch(ws1, ws2, lmat, h_ext, num_blocks, sup,
                             num_lags)
    elif device.type == "cpu":
        vals, idxs = coarse_rank_plain(ws1, ws2, lmat, h_ext, num_blocks,
                                       sup, num_lags, emulate_bf16=True)
    else:
        raise ValueError(f"fused_stein_rank: unsupported device {device}")
    if not want_idxs:
        idxs = torch.zeros_like(idxs)
    return vals, idxs


def _stage_a_smem_bytes(sup: int) -> int:
    """Dynamic shared memory of the kernel's stage-A block: two haystack
    windows of ``LAG_TILE + sup - 1`` samples and two tap rows of
    ``2*sup``, in f32."""
    return (2 * (LAG_TILE + sup - 1) + 4 * sup) * 4


def _launch(ws1, ws2, lmat, h_ext, num_blocks, sup, num_lags):
    global LAUNCHES
    from caf_cookoff_tpu_torch.ops import _build

    p, b2, _ = lmat.shape
    k = ws1.shape[0]
    if _stage_a_smem_bytes(sup) > _SMEM_PER_BLOCK:
        raise VmemBudgetError(
            f"fused Stein kernel: block_len {sup} needs "
            f"{_stage_a_smem_bytes(sup)} B of shared memory per block, "
            f"past the card's {_SMEM_PER_BLOCK} B; use the unfused path")
    if max(p, num_blocks, -(-k // 64)) > _GRID_YZ_MAX:
        raise ValueError(f"fused Stein kernel: grid too large "
                         f"(P={p}, B={num_blocks}, K={k})")
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
    g = torch.empty((p, b2, m_pad), dtype=bf16, device=dev)
    part_val = torch.empty((p, k, n_tiles), dtype=torch.float32, device=dev)
    part_lag = torch.empty((p, k, n_tiles), dtype=torch.int32, device=dev)
    vals = torch.empty((k, p), dtype=torch.float32, device=dev)
    lags = torch.empty((k, p), dtype=torch.int32, device=dev)
    # The launches go to the operands' card; the caller's current card
    # is restored afterwards.
    with torch.cuda.device(dev):
        rc = lib.caf_fused_stein_rank(
            ws1b.data_ptr(), ws2b.data_ptr(), lmatb.data_ptr(), h.data_ptr(),
            g.data_ptr(), part_val.data_ptr(), part_lag.data_ptr(),
            vals.data_ptr(), lags.data_ptr(), p, k, num_blocks, sup, h_len,
            num_lags, m_pad, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused Stein kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    LAUNCHES += 1
    return vals, lags
