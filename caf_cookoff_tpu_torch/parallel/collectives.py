"""Collective peak reduction over a :class:`~caf_cookoff_tpu_torch.
parallel.mesh.Mesh`.

The port of ``caf_cookoff_tpu/parallel/collectives.py``: per-rank
``(value, freq_idx, lag_idx)`` triples reduce to the replicated global
peak with ``all_reduce(MAX)`` on the value, then ``MIN`` tie-breaks on
(freq, lag) among the ranks that hold the max — the reference's "first
maximum in row-major order wins" — with global indices and no index
flattening.  The lattice reductions keep the JAX package's two
collectives (one ``all_gather`` of the value vector, one of the packed
int block), then every rank runs the same deterministic merge, so the
result is replicated by construction.

Every function is called by all ranks of the mesh with tensors on the
mesh's device; ``axis_names`` names the axes to reduce over.  With
``gloo`` collectives the payload (a few bytes a pair) goes to the CPU
and back.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from caf_cookoff_tpu_torch.models.rate import _merge_rate_lattice
from caf_cookoff_tpu_torch.ops.peak import CafPeak, merge_peaks
from caf_cookoff_tpu_torch.parallel.mesh import Mesh

_AxisNames = Union[str, Sequence[str]]

_INT_MAX = torch.iinfo(torch.int32).max


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A private contiguous copy of ``x`` where the mesh's backend sends
    from: the CPU for gloo, the mesh's card for NCCL."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return x.detach().to(dev, copy=True).contiguous()


def all_reduce(x: torch.Tensor, op, axis_names: _AxisNames, *,
               mesh: Mesh) -> torch.Tensor:
    """``op``-reduction of ``x`` over ``axis_names``; returned on
    ``x``'s device."""
    y = _wire(x, mesh)
    dist.all_reduce(y, op=op, group=mesh.group(axis_names))
    return y.to(x.device)


def all_gather(x: torch.Tensor, axis_names: _AxisNames, *,
               mesh: Mesh) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` over ``axis_names``, stacked in
    row-major mesh order (the JAX ``all_gather`` over those names)."""
    y = _wire(x, mesh)
    parts = [torch.empty_like(y) for _ in range(mesh.axis_size(axis_names))]
    dist.all_gather(parts, y, group=mesh.group(axis_names))
    return torch.stack(parts).to(x.device)


def all_gather_fields(fields, axis_names: _AxisNames, *, mesh: Mesh):
    """:func:`all_gather` of several tensors in ONE collective: their
    bytes travel as one uint8 block (every rank's fields have the same
    shapes and dtypes).  Returns one (n, *f.shape) tensor a field."""
    flat = [f.contiguous().reshape(-1).view(torch.uint8) for f in fields]
    got = all_gather(torch.cat(flat), axis_names, mesh=mesh)   # (n, bytes)
    out, start = [], 0
    for f, b in zip(fields, flat):
        part = got[:, start:start + b.numel()].contiguous()
        out.append(part.view(f.dtype).reshape(-1, *f.shape))
        start += b.numel()
    return out


def global_peak(local: CafPeak, axis_names: _AxisNames, *,
                mesh: Mesh) -> CafPeak:
    """Reduce per-rank peak triples to the replicated global peak.

    ``local`` carries *global* indices (the caller offsets them by its
    shard's start); fields may be batched (one peak per pair), and each
    element reduces on its own."""
    value = torch.as_tensor(local.value)
    freq_idx = local.freq_idx.to(torch.int32)
    lag_idx = local.lag_idx.to(torch.int32)
    m = all_reduce(value, dist.ReduceOp.MAX, axis_names, mesh=mesh)
    is_max = value >= m
    f_min = all_reduce(torch.where(is_max, freq_idx, _INT_MAX),
                       dist.ReduceOp.MIN, axis_names, mesh=mesh)
    l_min = all_reduce(
        torch.where(is_max & (freq_idx == f_min), lag_idx, _INT_MAX),
        dist.ReduceOp.MIN, axis_names, mesh=mesh)
    return CafPeak(value=m, freq_idx=f_min, lag_idx=l_min)


def global_peaks(local: CafPeak, axis_names: _AxisNames, num_peaks: int,
                 exclude_freq: int, exclude_lag: int, *,
                 mesh: Mesh) -> CafPeak:
    """Reduce per-rank top-``num_peaks`` lattices (fields
    ``(num_peaks,)``, global indices, empty slots -inf) to the global
    lattice: the candidates gather over ``axis_names`` in two
    collectives (values, and freq/lag as one packed (2, P) block) and
    every rank runs the same NMS merge, so an emitter that two
    neighbouring time shards both see collapses to one entry."""
    value = all_gather(torch.as_tensor(local.value), axis_names,
                       mesh=mesh).reshape(-1)
    idx = torch.stack([local.freq_idx.to(torch.int32),
                       local.lag_idx.to(torch.int32)])
    idx = all_gather(idx, axis_names, mesh=mesh)          # (n, 2, P)
    idx = idx.permute(1, 0, 2).reshape(2, -1)
    return merge_peaks(CafPeak(value, idx[0], idx[1]), num_peaks,
                       exclude_freq, exclude_lag)


def global_rate_peak(value, rate_idx, freq_idx, lag_idx,
                     axis_names: _AxisNames, *, mesh: Mesh):
    """Reduce per-rank (value, rate_idx, freq_idx, lag_idx) quads to the
    replicated global second-order peak: ``MAX`` on the value, then
    ``MIN`` tie-breaks walking (rate, freq, lag) — the single-device
    rate scan's earliest-rate, then row-major order.  Global indices."""
    value = torch.as_tensor(value)
    r, f, lg = (torch.as_tensor(x).to(torch.int32)
                for x in (rate_idx, freq_idx, lag_idx))
    m = all_reduce(value, dist.ReduceOp.MAX, axis_names, mesh=mesh)
    is_max = value >= m
    r_min = all_reduce(torch.where(is_max, r, _INT_MAX), dist.ReduceOp.MIN,
                       axis_names, mesh=mesh)
    on_r = is_max & (r == r_min)
    f_min = all_reduce(torch.where(on_r, f, _INT_MAX), dist.ReduceOp.MIN,
                       axis_names, mesh=mesh)
    l_min = all_reduce(torch.where(on_r & (f == f_min), lg, _INT_MAX),
                       dist.ReduceOp.MIN, axis_names, mesh=mesh)
    return m, r_min, f_min, l_min


def global_rate_peaks(value, key, lag, rate_idx, fws, rates,
                      axis_names: _AxisNames, num_peaks: int,
                      exclude_freq: int, exclude_lag: int, half_t_bins, *,
                      mesh: Mesh):
    """Reduce per-rank RATE lattices to the replicated global lattice:
    the two collectives of :func:`global_peaks` (values, and one packed
    4-field int block: centre-frequency key, lag, rate index,
    window-start bin), then the rate-aware NMS
    (:func:`caf_cookoff_tpu_torch.models.rate._merge_rate_lattice`, host
    numpy) on every rank.  Physical rates come from the replicated
    ``rates`` grid (numpy), so they never go over the wire.  Returns
    ``_merge_rate_lattice``'s six arrays."""
    value = all_gather(torch.as_tensor(value), axis_names,
                       mesh=mesh).reshape(-1)
    idx = torch.stack([torch.as_tensor(x).to(torch.int32)
                       for x in (key, lag, rate_idx, fws)])
    idx = all_gather(idx, axis_names, mesh=mesh)          # (n, 4, P)
    idx = idx.permute(1, 0, 2).reshape(4, -1).cpu().numpy()
    rates = np.asarray(rates)
    return _merge_rate_lattice(value.cpu().numpy(), idx[0], idx[1], idx[2],
                               idx[3], rates[idx[2]], num_peaks,
                               exclude_freq, exclude_lag, half_t_bins)


def global_peaks_batched(local: CafPeak, axis_names: _AxisNames,
                         num_peaks: int, exclude_freq: int,
                         exclude_lag: int, *, mesh: Mesh) -> CafPeak:
    """Batched lattice reduction: fields ``(..., num_peaks)`` (one
    lattice per local pair); the candidate axis, not the batch axes,
    folds across the mesh (two collectives), then a batched merge runs
    per element.  Replicated like :func:`global_peaks`."""
    value = torch.as_tensor(local.value)
    idx = torch.stack([local.freq_idx.to(torch.int32),
                       local.lag_idx.to(torch.int32)])    # (2, ..., C)

    def fold(x):
        g = all_gather(x, axis_names, mesh=mesh)         # (n, ..., C)
        g = torch.movedim(g, 0, -2)                      # (..., n, C)
        return g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1])

    value = fold(value)
    idx = fold(idx)
    return merge_peaks(CafPeak(value, idx[0], idx[1]), num_peaks,
                       exclude_freq, exclude_lag)
