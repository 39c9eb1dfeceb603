"""Multi-device CAF engines over a ``torch.distributed`` mesh.

The port of ``caf_cookoff_tpu/parallel/sharded.py``.  JAX writes each
engine as one ``shard_map`` program over a single-controller mesh; here
the engines are SPMD: every rank calls the engine with the same host
inputs, cuts its own shard, runs the port's single-device code on its
device, and the shards meet in the collectives of
:mod:`caf_cookoff_tpu_torch.parallel.collectives` over the mesh's
groups, so every rank returns the same answer.

* ``doppler`` — frequency bins sharded (the grid padded by repeating its
  last bin, whose duplicate loses every lowest-index tie-break); peaks
  reduce by ``MAX`` then ``MIN`` tie-breaks;
* ``pair``    — independent pairs (or, in the serial rate engines, the
  trial rates); results gather over the axis;
* ``time``    — long captures: lag chunks (the cuFFT overlap-save
  engines) or overlap-save windows (the fused Stein engines, with K1 in
  each shard).

The time halo: JAX sends the ``N-1`` samples after each chunk to the
left neighbour with ``ppermute``.  Every rank here holds the whole
capture, so it slices its chunk and the halo after it (zeros past the
last chunk, as ``ppermute`` fills) — the same samples without a
collective.  :func:`streaming_peak_deferred_halo` keeps the JAX split of
a chunk's scan into the blocks that read only the chunk and those that
read the halo.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed import ReduceOp

from caf_cookoff_tpu_torch.config import (resolve_backend, signal_grid,
                                          xcor_length)
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models._stein_plan import (_auto_block_len, _host,
                                                      _pow2_block_len,
                                                      _windowed_route)
from caf_cookoff_tpu_torch.models.batched_stein import (
    _batched_stein_core, _batched_stein_peaks_core, _best_window,
    _coarse_rank, _exclusions, _lattice_from_bin_candidates, _os_operands,
    _os_topk_refine, _rescore_entries_windowed, _rescore_guards,
    _stein_model_floor, _stein_os_peaks)
from caf_cookoff_tpu_torch.models.filterbank import caf_surface
from caf_cookoff_tpu_torch.models.overlap_save import (detection_rows,
                                                       mean_floor,
                                                       needle_spectra_conj,
                                                       plan_blocks,
                                                       streaming_peak)
from caf_cookoff_tpu_torch.models.rate import (_merge_rate_lattice,
                                               _prechirp, _rate_batches,
                                               _rate_coarse_closer,
                                               _rate_grid_half_t_bins,
                                               _rate_ranks, _segmented_inputs)
from caf_cookoff_tpu_torch.models.stein import (_doppler_synthesis,
                                                _refine_topk,
                                                _segment_correlations)
from caf_cookoff_tpu_torch.ops.fused_stein import FUSED_TILE, SUPER
from caf_cookoff_tpu_torch.ops.pallas_caf import pallas_caf_peak
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, apply_detection_threshold,
                                            as_lattice, concat_peaks,
                                            find_peak_2d, merge_peaks,
                                            resolve_exclusions)
from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2, pad_to
from caf_cookoff_tpu_torch.parallel.collectives import (all_gather,
                                                        all_gather_fields,
                                                        all_reduce,
                                                        global_peak,
                                                        global_peaks,
                                                        global_peaks_batched,
                                                        global_rate_peak,
                                                        global_rate_peaks)
from caf_cookoff_tpu_torch.parallel.mesh import (AXIS_DOPPLER, AXIS_PAIR,
                                                 AXIS_TIME, Mesh)
from caf_cookoff_tpu_torch.utils.convert import as_signal

_DT = (AXIS_DOPPLER, AXIS_TIME)
_ALL = (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME)
# The windowed engines' error for a grid neither route takes.
_NO_ROUTE = ("grid neither fits the single-band envelope nor bands "
             "cleanly; use %s for it")


def pad_axis_to(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad ``x`` along ``axis`` to a multiple by repeating the last slice.

    Used on the doppler grid: duplicated frequencies produce duplicate
    surface rows, and the lowest-index tie-break in the peak reduction
    guarantees the original row wins, so padding never changes results.
    """
    x = np.asarray(x)
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    last = np.take(x, [size - 1] * (target - size), axis=axis)
    return np.concatenate([x, last], axis=axis)


def _shard(x, mesh: Mesh, axis: str):
    """This rank's block of ``x``'s leading axis (divisible by the mesh
    axis's size)."""
    size = x.shape[0] // mesh.shape[axis]
    i = mesh.axis_index(axis)
    return x[i * size:(i + 1) * size]


def _doppler_grid(freqs_hz, mesh: Mesh, sig: torch.Tensor):
    """(grid in ``sig``'s real dtype, padded grid, this rank's bins as a
    tensor, its first bin)."""
    freqs = signal_grid(freqs_hz, sig)
    freqs_p = pad_axis_to(freqs, mesh.shape[AXIS_DOPPLER])
    loc = _shard(freqs_p, mesh, AXIS_DOPPLER)
    k0 = mesh.axis_index(AXIS_DOPPLER) * len(loc)
    return freqs, freqs_p, _tensor(loc, mesh), k0


def _tensor(x: np.ndarray, mesh: Mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def _offset(pk: CafPeak, k0: int) -> CafPeak:
    return CafPeak(pk.value, pk.freq_idx + k0, pk.lag_idx)


def _gather_pairs(mesh: Mesh, *fields):
    """Each (B_loc, ...) field gathered over ``pair`` into (B, ...), all
    in one collective."""
    return [g.reshape(-1, *f.shape[1:]) for f, g in zip(
        fields, all_gather_fields(fields, AXIS_PAIR, mesh=mesh))]


def _pair_batch(needles, haystacks, mesh: Mesh, equal: bool):
    ns = as_signal(needles, mesh.device)
    hs = as_signal(haystacks, mesh.device).to(ns.dtype)
    if equal:
        if ns.ndim != 2 or hs.shape != ns.shape:
            raise ValueError(
                f"need matching (B, N) batches, got {tuple(ns.shape)} vs "
                f"{tuple(hs.shape)}")
    elif ns.ndim != 2 or hs.ndim != 2 or ns.shape[0] != hs.shape[0]:
        raise ValueError(
            f"need (B, N) needles and (B, L) haystacks, got "
            f"{tuple(ns.shape)} vs {tuple(hs.shape)}")
    if ns.shape[0] % mesh.shape[AXIS_PAIR]:
        raise ValueError(f"batch {ns.shape[0]} not divisible by pair axis "
                         f"{mesh.shape[AXIS_PAIR]}")
    return ns, hs


def _filterbank_backend(backend, pallas: bool = False) -> str:
    """A resolved backend the engine's shards can run: the FFT names, and
    with ``pallas`` also the ``pallas*`` names (K2/K3 in each shard)."""
    backend = resolve_backend(backend)
    if backend.startswith("stein") or (backend.startswith("pallas")
                                       and not pallas):
        raise ValueError(f"backend {backend!r}: this sharded engine runs "
                         f"the FFT{' and pallas' if pallas else ''} "
                         "backends")
    return backend


def streaming_peak_deferred_halo(s_conj, h_local, h_halo, needle_len: int,
                                 chunk: int, lag_offset: int,
                                 total_lags: Optional[int], backend=None,
                                 num_peaks: int = 1,
                                 exclude_freq: Optional[int] = None,
                                 exclude_lag: Optional[int] = None,
                                 valid_rows=None, with_floor: bool = False):
    """Shard-local overlap-save scan of ``chunk`` lags, the halo read
    only by the boundary blocks.

    A block covering local lags ``[b*V, b*V + V)`` reads samples
    ``[b*V, b*V + V + N - 1)``; the blocks whose reads stay inside the
    shard's own ``chunk`` samples run first (the interior scan), the
    last ``<= ceil((N-1)/V) + 1`` blocks read ``chunk`` plus ``h_halo``
    (the boundary scan).  Semantics of
    :func:`~caf_cookoff_tpu_torch.models.overlap_save.streaming_peak`
    over ``cat([h_local, h_halo])``: the same masks, the earliest lag on
    ties (the boundary wins only on a strictly greater value), floor
    sums over the two disjoint lag ranges.  With ``num_peaks > 1`` the
    boundary blocks fold their own lattice before the merge with the
    interior one, so slots at sidelobe level may differ from one scan
    (the JAX package's contract).  ``s_conj`` (..., K, M) and the
    haystacks (..., L) may carry a leading axis."""
    resolve_backend(backend)
    _, v, nblocks = plan_blocks(needle_len, chunk)
    d = v + needle_len - 1
    b_int = min((chunk - d) // v + 1, nblocks) if chunk >= d else 0
    kw = dict(total_lags=total_lags, num_peaks=num_peaks,
              exclude_freq=exclude_freq, exclude_lag=exclude_lag,
              valid_rows=valid_rows, with_floor=with_floor)
    if b_int <= 0:
        ext = torch.cat([h_local, h_halo], dim=-1)
        return streaming_peak(s_conj, ext, needle_len, chunk,
                              lag_offset=lag_offset, **kw)
    lags_int = b_int * v           # b_int*v + N-1 <= chunk: local only
    out_i = streaming_peak(s_conj, h_local, needle_len, lags_int,
                           lag_offset=lag_offset, **kw)
    tail = torch.cat([h_local[..., lags_int:], h_halo], dim=-1)
    out_b = streaming_peak(s_conj, tail, needle_len, chunk - lags_int,
                           lag_offset=lag_offset + lags_int, **kw)
    pk_i, pk_b = (out_i[0], out_b[0]) if with_floor else (out_i, out_b)
    if num_peaks > 1:
        pk = merge_peaks(concat_peaks(pk_i, pk_b), num_peaks, exclude_freq,
                         exclude_lag)
    else:
        take = pk_b.value > pk_i.value   # strict: earlier lags win ties
        pk = CafPeak(torch.where(take, pk_b.value, pk_i.value),
                     torch.where(take, pk_b.freq_idx, pk_i.freq_idx),
                     torch.where(take, pk_b.lag_idx, pk_i.lag_idx))
    if with_floor:
        return pk, out_i[1] + out_b[1], out_i[2] + out_b[2]
    return pk


# ---------------------------------------------------------------------------
# Doppler-sharded filterbank surface / peak (truncated-haystack workload)
# ---------------------------------------------------------------------------


def _pair_signals(needle, haystack, mesh: Mesh):
    n = as_signal(needle, mesh.device)
    h = as_signal(haystack, mesh.device).to(n.dtype)
    if n.shape[-1] != h.shape[-1]:
        raise ValueError(
            f"needle/haystack length mismatch: {n.shape[-1]} vs "
            f"{h.shape[-1]} (truncate the haystack to the needle length)")
    return n, h


def sharded_caf_surface(needle, haystack, freqs_hz, sample_rate,
                        mesh: Mesh, *,
                        backend: Optional[str] = None) -> torch.Tensor:
    """(K, M) mag^2 surface with doppler bins sharded over the mesh.

    Same contract as :func:`caf_cookoff_tpu_torch.caf_surface`; each
    rank builds its bins' rows (``pallas*`` backends through K3) and the
    rows gather over ``doppler``, so every rank returns the whole
    surface on its device."""
    backend = _filterbank_backend(backend, pallas=True)
    n, h = _pair_signals(needle, haystack, mesh)
    freqs, _, loc, _ = _doppler_grid(freqs_hz, mesh, n)
    rows = caf_surface(n, h, loc.cpu().numpy(), float(sample_rate),
                       backend=backend, device=mesh.device)
    full = all_gather(rows, AXIS_DOPPLER, mesh=mesh)
    return full.reshape(-1, rows.shape[-1])[:len(freqs)]


def sharded_caf_peak(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                     *, backend: Optional[str] = None
                     ) -> Tuple[float, int, float]:
    """(freq_hz, lag_idx, value): doppler-sharded fused surface+peak.

    The surface never materializes: each rank reduces its bin block
    (``pallas*`` backends through K2) and the triples meet in the
    ``MAX``/``MIN`` reduction over ``doppler``."""
    local, freqs_p = _caf_peak_shard(needle, haystack, freqs_hz,
                                     sample_rate, mesh, backend)
    peak = global_peak(local, AXIS_DOPPLER, mesh=mesh)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


def _caf_peak_shard(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                    backend):
    """This rank's share of :func:`sharded_caf_peak`, no collective: (the
    peak of its bins, global indices; the padded grid)."""
    backend = _filterbank_backend(backend, pallas=True)
    n, h = _pair_signals(needle, haystack, mesh)
    _, freqs_p, loc, k0 = _doppler_grid(freqs_hz, mesh, n)
    fs = float(sample_rate)
    m = xcor_length(n.shape[-1])
    if backend.startswith("pallas"):
        _, _, tier = backend.partition("-")
        local = pallas_caf_peak(n, h, loc.cpu().numpy(), fs, m,
                                precision=tier or "high")
    else:
        local = find_peak_2d(mag2(_surface_rows(n, h, loc, fs, m)))
    return _offset(local, k0), freqs_p


def sharded_stein_peak(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                       *, block_len: int = 64, refine: bool = True,
                       backend: Optional[str] = None
                       ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value): Stein synthesis sharded over ``doppler``.

    The segment correlations replicate (they do not depend on the bins);
    each rank synthesizes and reduces its own bins.  With ``refine`` the
    per-bin row maxima gather over ``doppler`` (K floats) and every rank
    re-scores the global top candidates with exact filterbank rows — the
    rank-then-score design of the single-device engine."""
    _filterbank_backend(backend)
    n, h = _pair_signals(needle, haystack, mesh)
    freqs, freqs_p, loc, k0 = _doppler_grid(freqs_hz, mesh, n)
    fs = float(sample_rate)
    block_len = _auto_block_len(fs, freqs, block_len)
    m = xcor_length(n.shape[-1])
    g = _segment_correlations(n, h, m, block_len)
    rr, ri = _doppler_synthesis(g, loc, fs, block_len)
    surface = rr * rr + ri * ri
    if not refine:
        peak = global_peak(_offset(find_peak_2d(surface), k0), AXIS_DOPPLER,
                           mesh=mesh)
    else:
        rowmax = all_gather(torch.amax(surface, dim=-1), AXIS_DOPPLER,
                            mesh=mesh).reshape(-1)
        # Grid padding duplicates the last bin: out of the ranking.
        rowmax = torch.where(torch.arange(len(freqs_p), device=rowmax.device)
                             < len(freqs), rowmax, -math.inf)
        peak = _refine_topk(n, h, _tensor(freqs_p, mesh), rowmax, fs, m,
                            num_valid=len(freqs))
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


# ---------------------------------------------------------------------------
# Pair (+ doppler) sharded batch engines (many signal pairs at once)
# ---------------------------------------------------------------------------


def batched_caf_peak(needles, haystacks, freqs_hz, sample_rate, mesh: Mesh,
                     *, backend: Optional[str] = None):
    """Peaks for a batch of pairs: (freqs (B,), lags (B,), values (B,)).

    Pairs are data-parallel over ``pair``, bins over ``doppler``; each
    pair's triples reduce over ``doppler``, then gather over ``pair``."""
    local, freqs_p = _batched_caf_peak_shard(needles, haystacks, freqs_hz,
                                             sample_rate, mesh, backend)
    pk = CafPeak(*_gather_pairs(
        mesh, *global_peak(local, AXIS_DOPPLER, mesh=mesh)))
    return _host(freqs_p, pk)


def _batched_caf_peak_shard(needles, haystacks, freqs_hz, sample_rate,
                            mesh: Mesh, backend):
    """This rank's share of :func:`batched_caf_peak`, no collective: (the
    (B_loc,) peaks of its pairs over its bins, global bin indices; the
    padded grid)."""
    _filterbank_backend(backend)
    ns, hs = _pair_batch(needles, haystacks, mesh, equal=True)
    _, freqs_p, loc, k0 = _doppler_grid(freqs_hz, mesh, ns)
    rows = _surface_rows(_shard(ns, mesh, AXIS_PAIR),
                         _shard(hs, mesh, AXIS_PAIR), loc,
                         float(sample_rate), xcor_length(ns.shape[-1]))
    return _offset(find_peak_2d(mag2(rows)), k0), freqs_p


def _fused_batch_grid(ns, freqs_hz, sample_rate, block_len: int):

    freqs = signal_grid(freqs_hz, ns)
    return freqs, _pow2_block_len(float(sample_rate), freqs, block_len)


def sharded_batched_stein_peak(needles, haystacks, freqs_hz, sample_rate,
                               mesh: Mesh, *, block_len: int = 64,
                               backend: Optional[str] = None):
    """Per-pair peaks with the FUSED batch engine sharded over ``pair``:
    each rank runs K1 on its pair block and re-scores its pairs exactly
    (pure data parallelism); the results gather over ``pair``.  The bins
    replicate (the synthesis weights are O(K*B))."""
    resolve_backend(backend)
    ns, hs = _pair_batch(needles, haystacks, mesh, equal=True)
    freqs, d = _fused_batch_grid(ns, freqs_hz, sample_rate, block_len)
    n = ns.shape[-1]
    m = xcor_length(n)
    if m % FUSED_TILE:
        raise EligibilityError(
            f"xcor length {m} not a multiple of {FUSED_TILE}")
    pk = _batched_stein_core(pad_to(_shard(ns, mesh, AXIS_PAIR),
                                    n + (-n) % SUPER),
                             _shard(hs, mesh, AXIS_PAIR),
                             _tensor(freqs, mesh), float(sample_rate), m, d,
                             True)
    return _host(freqs, CafPeak(*_gather_pairs(mesh, *pk)))


def sharded_batched_stein_peaks(needles, haystacks, freqs_hz, sample_rate,
                                mesh: Mesh, num_peaks: int, *,
                                block_len: int = 64,
                                exclude_freq: Optional[int] = None,
                                exclude_lag: Optional[int] = None,
                                backend: Optional[str] = None,
                                min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR with K1's top-2 mode, pairs
    sharded over ``pair`` — the multi-emitter variant of
    :func:`sharded_batched_stein_peak` (no collectives but the gather of
    the results).  Returns ``(freqs (B, P), lags (B, P), values (B, P)[,
    snr_db])``, lags CIRCULAR; ``min_snr_db`` thresholds against the
    per-pair model floor."""
    resolve_backend(backend)
    ns, hs = _pair_batch(needles, haystacks, mesh, equal=True)
    freqs, d = _fused_batch_grid(ns, freqs_hz, sample_rate, block_len)
    fs = float(sample_rate)
    n = ns.shape[-1]
    m = xcor_length(n)
    ef, el, auto_lag = _exclusions(ns, freqs, fs, exclude_freq, exclude_lag)
    # Circular path: the period m, not n (see batched_stein_peaks).
    guard, rescore_win = _rescore_guards(n, auto_lag, m)
    pk = _batched_stein_peaks_core(
        _shard(ns, mesh, AXIS_PAIR), _shard(hs, mesh, AXIS_PAIR),
        _tensor(freqs, mesh), fs, m, d, int(num_peaks), ef, el, guard,
        rescore_win)
    pk = CafPeak(*_gather_pairs(mesh, *pk))
    if min_snr_db is None and not with_snr:
        return _host(freqs, pk)
    return detection_rows(freqs, pk, _stein_model_floor(ns.cpu().numpy(),
                                                        hs.cpu().numpy()),
                          len(freqs) * m, min_snr_db, with_snr)


# ---------------------------------------------------------------------------
# Time-sharded overlap-save engines (long captures over the mesh)
# ---------------------------------------------------------------------------


def _time_chunks(hay: torch.Tensor, n: int, num_lags, mesh: Mesh):
    """(total_lags, chunk, this rank's chunk, its halo, its first lag):
    chunks sized from the SAMPLES the lags need (lag ``l`` reads
    ``[l, l+n-1]``), at least the halo long; the capture padded or cut
    to ``time * chunk``; the halo is the next chunk's first ``n-1``
    samples, zeros after the last chunk."""
    length = hay.shape[-1]
    if length < n:
        raise ValueError("haystack shorter than needle")
    total_lags = num_lags or length - n + 1
    t_shards = mesh.shape[AXIS_TIME]
    needed = min(length, total_lags + n - 1)
    chunk = max(-(-needed // t_shards), n - 1)
    width = t_shards * chunk
    hay = pad_to(hay, width) if width > length else hay[..., :width]
    hay = pad_to(hay, width + n - 1)
    t = mesh.axis_index(AXIS_TIME)
    return (total_lags, chunk, hay[..., t * chunk:(t + 1) * chunk],
            hay[..., (t + 1) * chunk:(t + 1) * chunk + n - 1], t * chunk)


def _os_inputs(needle, haystack, freqs_hz, mesh: Mesh, num_lags):
    n = as_signal(needle, mesh.device)
    h = as_signal(haystack, mesh.device).to(n.dtype)
    chunks = _time_chunks(h, n.shape[-1], num_lags, mesh)
    return (n, h) + chunks + _doppler_grid(freqs_hz, mesh, n)


def sharded_overlap_save_peak(needle, haystack, freqs_hz, sample_rate,
                              mesh: Mesh, num_lags: Optional[int] = None, *,
                              backend: str = "matmul"
                              ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value) of a long capture sharded over ``time`` (and
    ``doppler``): each rank scans its lag chunk with its halo, and the
    triples reduce over ``(doppler, time)``."""
    local, freqs_p = _os_peak_shard(needle, haystack, freqs_hz, sample_rate,
                                    mesh, num_lags, backend)
    peak = global_peak(local, _DT, mesh=mesh)
    return (float(freqs_p[int(peak.freq_idx)]), int(peak.lag_idx),
            float(peak.value))


def _os_peak_shard(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                   num_lags, backend):
    """This rank's share of :func:`sharded_overlap_save_peak`, no
    collective: (the peak of its lag chunk and bins, global indices; the
    padded grid)."""
    resolve_backend(backend)
    (n, _, total_lags, chunk, local, halo, offset, _, freqs_p, loc,
     k0) = _os_inputs(needle, haystack, freqs_hz, mesh, num_lags)
    nl = n.shape[-1]
    m, _, _ = plan_blocks(nl, chunk)
    s_conj = needle_spectra_conj(n, loc, float(sample_rate), m)
    pk = streaming_peak_deferred_halo(s_conj, local, halo, nl, chunk, offset,
                                      total_lags, backend)
    return _offset(pk, k0), freqs_p


def _os_lattice(s_conj, local, halo, nl, chunk, offset, total_lags, p, ef,
                el, valid_rows, want_floor, k0):
    """A rank's lattice (fields (..., P), global bins) and floor sums."""
    out = streaming_peak_deferred_halo(
        s_conj, local, halo, nl, chunk, offset, total_lags, None,
        num_peaks=p, exclude_freq=ef, exclude_lag=el, valid_rows=valid_rows,
        with_floor=want_floor)
    pk = out[0] if want_floor else out
    if p == 1:
        pk = as_lattice(pk)
    return _offset(pk, k0), (out[1:] if want_floor else None)


def sharded_overlap_save_peaks(needle, haystack, freqs_hz, sample_rate,
                               mesh: Mesh, num_peaks: int,
                               num_lags: Optional[int] = None, *,
                               exclude_freq: Optional[int] = None,
                               exclude_lag: Optional[int] = None,
                               backend: str = "matmul",
                               min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters of a time-sharded long capture: each
    rank's scan carries an NMS lattice over its chunk, the lattices meet
    in :func:`global_peaks` over ``(doppler, time)`` (emitters that
    neighbouring chunks both see through the halo deduplicate), grid pad
    rows masked.  ``min_snr_db`` / ``with_snr`` threshold against the
    global measured floor (two ``SUM`` reductions).  Returns ``(freqs
    (P,), lags (P,), values (P,)[, snr_db (P,)])``."""
    resolve_backend(backend)
    (n, _, total_lags, chunk, local, halo, offset, freqs, freqs_p, loc,
     k0) = _os_inputs(needle, haystack, freqs_hz, mesh, num_lags)
    fs = float(sample_rate)
    nl = n.shape[-1]
    ef, el = resolve_exclusions(n, freqs, fs, exclude_freq, exclude_lag)
    m, _, _ = plan_blocks(nl, chunk)
    s_conj = needle_spectra_conj(n, loc, fs, m)
    rows = k0 + torch.arange(len(loc), device=mesh.device)
    want_floor = with_snr or min_snr_db is not None
    p = int(num_peaks)
    pk, floor = _os_lattice(s_conj, local, halo, nl, chunk, offset,
                            total_lags, p, ef, el, rows < len(freqs),
                            want_floor, k0)
    lat = global_peaks(pk, _DT, p, ef, el, mesh=mesh)
    if not want_floor:
        return _host(freqs_p, lat)
    fsum, fcnt = (all_reduce(x, ReduceOp.SUM, _DT,
                             mesh=mesh) for x in floor)
    return detection_rows(freqs_p, lat, mean_floor(fsum, fcnt),
                          total_lags * len(freqs), min_snr_db, with_snr)


def _batched_os_inputs(needles, haystacks, freqs_hz, mesh: Mesh, num_lags):
    ns, hs = _pair_batch(needles, haystacks, mesh, equal=False)
    if hs.shape[-1] < ns.shape[-1]:
        raise ValueError("haystacks shorter than needles")
    ns_l = _shard(ns, mesh, AXIS_PAIR)
    chunks = _time_chunks(_shard(hs, mesh, AXIS_PAIR), ns.shape[-1],
                          num_lags, mesh)
    return (ns, ns_l) + chunks + _doppler_grid(freqs_hz, mesh, ns)


def batched_overlap_save_peak(needles, haystacks, freqs_hz, sample_rate,
                              mesh: Mesh, num_lags: Optional[int] = None, *,
                              backend: str = "matmul"):
    """Per-pair (freqs (B,), lags (B,), values (B,)) of long captures
    sharded over ALL THREE axes (``bench_configs.py`` config 5's
    pattern): pairs over ``pair``, each pair's lags chunked over
    ``time``, bins over ``doppler``; per-pair triples reduce over
    ``(doppler, time)`` and gather over ``pair``.  See
    :func:`estimate_hbm_per_chip` for the per-device memory model."""
    resolve_backend(backend)
    (ns, ns_l, total_lags, chunk, local, halo, offset, _, freqs_p, loc,
     k0) = _batched_os_inputs(needles, haystacks, freqs_hz, mesh, num_lags)
    nl = ns.shape[-1]
    m, _, _ = plan_blocks(nl, chunk)
    s_conj = needle_spectra_conj(ns_l, loc, float(sample_rate), m)
    pk = streaming_peak_deferred_halo(s_conj, local, halo, nl, chunk, offset,
                                      total_lags, backend)   # (B_loc,)
    pk = global_peak(_offset(pk, k0), _DT, mesh=mesh)
    return _host(freqs_p, CafPeak(*_gather_pairs(mesh, *pk)))


def batched_overlap_save_peaks(needles, haystacks, freqs_hz, sample_rate,
                               mesh: Mesh, num_peaks: int,
                               num_lags: Optional[int] = None, *,
                               exclude_freq: Optional[int] = None,
                               exclude_lag: Optional[int] = None,
                               backend: str = "matmul",
                               min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR on the three-axis mesh:
    ``(freqs (B, P), lags (B, P), values (B, P)[, snr (B, P)])``,
    strongest first, empty slots -inf.  Per-pair lattices fold over
    ``(doppler, time)`` (:func:`global_peaks_batched`); exclusion windows
    default to the first needle's resolution cell; each pair is
    thresholded against its own floor, summed over ``(doppler,
    time)``."""
    want_floor = with_snr or min_snr_db is not None
    p = int(num_peaks)
    pk, floor, (freqs, freqs_p, total_lags, ef, el) = _batched_os_peaks_shard(
        needles, haystacks, freqs_hz, sample_rate, mesh, p, num_lags,
        exclude_freq, exclude_lag, backend, want_floor)
    lat = CafPeak(*_gather_pairs(
        mesh, *global_peaks_batched(pk, _DT, p, ef, el, mesh=mesh)))
    if not want_floor:
        return _host(freqs_p, lat)
    fsum, fcnt = _gather_pairs(mesh, *(
        all_reduce(x, ReduceOp.SUM, _DT, mesh=mesh)
        for x in floor))
    return detection_rows(freqs_p, lat, mean_floor(fsum, fcnt),
                          total_lags * len(freqs), min_snr_db, with_snr)


def _batched_os_peaks_shard(needles, haystacks, freqs_hz, sample_rate,
                            mesh: Mesh, num_peaks: int, num_lags,
                            exclude_freq, exclude_lag, backend,
                            want_floor: bool = False):
    """This rank's share of :func:`batched_overlap_save_peaks`, no
    collective: its pairs' (B_loc, P) lattices over its lag chunk and
    bins (global indices), its floor sums (or None), and (grid, padded
    grid, total lags, exclusion windows)."""
    resolve_backend(backend)
    (ns, ns_l, total_lags, chunk, local, halo, offset, freqs, freqs_p, loc,
     k0) = _batched_os_inputs(needles, haystacks, freqs_hz, mesh, num_lags)
    fs = float(sample_rate)
    nl = ns.shape[-1]
    ef, el = resolve_exclusions(ns[0], freqs, fs, exclude_freq, exclude_lag)
    m, _, _ = plan_blocks(nl, chunk)
    s_conj = needle_spectra_conj(ns_l, loc, fs, m)
    rows = k0 + torch.arange(len(loc), device=mesh.device)
    pk, floor = _os_lattice(s_conj, local, halo, nl, chunk, offset,
                            total_lags, int(num_peaks), ef, el,
                            rows < len(freqs), want_floor, k0)
    return pk, floor, (freqs, freqs_p, total_lags, ef, el)


def estimate_hbm_per_chip(num_pairs: int, num_bins: int, needle_len: int,
                          total_lags: int, *, pair: int = 1,
                          doppler: int = 1, time: int = 1,
                          bytes_per_real: int = 4) -> dict:
    """Per-device memory bytes for the batched overlap-save engine (the
    JAX package's model, unchanged).

    Model (complex values as 2 real planes everywhere):

    * haystack shard:   (B/pair) x chunk            x 2 planes
    * needle replicas:  (B/pair) x N                x 2
    * shifted needle spectra (the dominant term):
                        (B/pair) x (K/doppler) x M  x 2
    * per-block scratch: (K/doppler) x M x 2 (streamed, x2 for ping-pong)

    where M = xcor_length(N) and chunk ~= (total_lags + N)/time.  An
    upper bound for a fits-per-device check, not a prediction of live
    bytes.
    """
    m = xcor_length(needle_len)
    b_loc = -(-num_pairs // pair)
    k_loc = -(-num_bins // doppler)
    chunk = max(-(-(total_lags + needle_len - 1) // time), needle_len - 1)
    hay = b_loc * chunk * 2 * bytes_per_real
    needles = b_loc * needle_len * 2 * bytes_per_real
    spectra = b_loc * k_loc * m * 2 * bytes_per_real
    scratch = 2 * k_loc * m * 2 * bytes_per_real
    total = hay + needles + spectra + scratch
    return {
        "haystack_shard_mb": round(hay / 2**20, 1),
        "needle_mb": round(needles / 2**20, 1),
        "needle_spectra_mb": round(spectra / 2**20, 1),
        "block_scratch_mb": round(scratch / 2**20, 1),
        "total_gb": round(total / 2**30, 3),
    }


# ---------------------------------------------------------------------------
# Fused windowed engines: overlap-save windows over ``time``, K1 in each
# shard
# ---------------------------------------------------------------------------


def _window_block(mesh: Mesh, windows: int):
    """(first window, windows a shard): the last shard's windows past
    ``windows`` read zeros and rank nothing (lag bound 0)."""
    wl = -(-windows // mesh.shape[AXIS_TIME])
    return mesh.axis_index(AXIS_TIME) * wl, wl


def _shard_operands(ns_k, hs, centers_t, rel_t, fs, v, d, w0, wl,
                    total_lags):
    """K1's operands of this shard's ``wl`` windows from window ``w0``:
    the single-device engine's operands of the capture from sample
    ``w0*v`` (so each window reads the same samples), lag bounds
    ``clip(total - (w0+w)*v, 0, v)``."""
    return _os_operands(ns_k, hs[..., w0 * v:], centers_t, rel_t, fs, v, d,
                        wl, total_lags - w0 * v)


def _long_pair(needle, haystack, mesh: Mesh):
    n = as_signal(needle, mesh.device)
    h = as_signal(haystack, mesh.device).to(n.dtype)
    if h.shape[-1] <= n.shape[-1]:
        raise ValueError("haystack must be longer than the needle")
    return n, h


def _time_best(rowmax_loc, rowlag_loc, mesh: Mesh):
    """Per row, the best shard of the ``time``-gathered coarse (value,
    lag) rows — the earliest on ties, so the flat single-device argmax
    over windows is reproduced exactly."""
    vals, lags = all_gather_fields((rowmax_loc, rowlag_loc), AXIS_TIME,
                                   mesh=mesh)
    tbest = torch.argmax(vals, dim=0, keepdim=True)
    return (torch.gather(vals, 0, tbest)[0], torch.gather(lags, 0, tbest)[0])


def sharded_stein_os_peak(needle, haystack, freqs_hz, sample_rate,
                          mesh: Mesh, num_lags: Optional[int] = None, *,
                          block_len: int = 64,
                          backend: Optional[str] = None
                          ) -> Tuple[float, int, float]:
    """(freq_hz, lag, value): the FUSED windowed long-capture engine
    (``models/batched_stein.batched_stein_os_peak``) with its window axis
    sharded over ``time``.

    Each rank runs its consecutive overlap-save windows as K1 programs
    against the replicated capture (windows are independent given their
    slices); the only collectives gather the (K,) coarse per-bin
    (value, lag) over ``time``, in window order, so the per-bin
    earliest-window tie-break — and every answer — equals the
    single-device engine's bit for bit.  The exact re-score then runs on
    every rank.  Wide uniform grids band as on one device."""
    resolve_backend(backend)
    n, h = _long_pair(needle, haystack, mesh)
    freqs = signal_grid(freqs_hz, n)
    fs = float(sample_rate)
    try:
        use_banded, d, freqs_pad, centers, rel = _windowed_route(
            fs, freqs, lambda: _pow2_block_len(fs, freqs, block_len))
    except SpanError:
        raise EligibilityError(
            _NO_ROUTE % "sharded_overlap_save_peak") from None
    nl = n.shape[-1]
    m = xcor_length(nl)
    total_lags = num_lags or h.shape[-1] - nl + 1
    w0, wl = _window_block(mesh, -(-total_lags // m))
    ns_k = n[None] if use_banded else pad_to(n[None], nl + (-nl) % SUPER)
    out_freqs = freqs_pad if use_banded else freqs
    ops, b, sup, modes = _shard_operands(
        ns_k, h[None], _tensor(centers, mesh) if use_banded else None,
        _tensor(rel, mesh), fs, m, d, w0, wl, total_lags)
    vals, idxs = _coarse_rank(*ops, b, sup, m, **modes)
    kb, s = len(rel), modes["share_h"]
    rowmax, rowlag = _best_window(vals.reshape(kb, s, wl),
                                  idxs.reshape(kb, s, wl), m,
                                  total_lags - w0 * m)      # (Kb, S)
    rowmax, rowlag = _time_best(rowmax.T.reshape(-1),
                                (rowlag + w0 * m).T.reshape(-1), mesh)
    num_bins = len(freqs) if use_banded else None
    if num_bins is not None:
        rowmax = torch.where(torch.arange(s * kb, device=rowmax.device)
                             < num_bins, rowmax, -math.inf)
    pk = _os_topk_refine(ns_k, h[None], _tensor(out_freqs, mesh),
                         rowmax[None], rowlag[None], fs, m, total_lags, nl,
                         num_valid_bins=num_bins)
    return (float(out_freqs[int(pk.freq_idx[0])]), int(pk.lag_idx[0]),
            float(pk.value[0]))


def sharded_stein_os_peaks(needle, haystack, freqs_hz, sample_rate,
                           mesh: Mesh, num_peaks: int,
                           num_lags: Optional[int] = None, *,
                           block_len: int = 64,
                           exclude_freq: Optional[int] = None,
                           exclude_lag: Optional[int] = None,
                           backend: Optional[str] = None,
                           min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters of one long capture, FUSED windowed
    engine with K1's top-2 mode, windows sharded over ``time``.

    Each rank folds its windows' per-bin candidate slots into a local
    lattice; the lattices meet in :func:`global_peaks` over ``time``,
    and the candidate slots gather in window order (K x W*2 values and
    lags) so every rank re-scores the global lattice identically against
    the replicated capture.  Returns ``(freqs (P,), lags (P,), values
    (P,)[, snr_db])``; detection against the model floor."""
    resolve_backend(backend)
    n, h = _long_pair(needle, haystack, mesh)
    freqs = signal_grid(freqs_hz, n)
    fs = float(sample_rate)
    try:
        use_banded, d, freqs_pad, centers, rel = _windowed_route(
            fs, freqs, lambda: _pow2_block_len(fs, freqs, block_len))
    except SpanError:
        raise EligibilityError(
            _NO_ROUTE % "sharded_overlap_save_peaks") from None
    nl = n.shape[-1]
    m = xcor_length(nl)
    total_lags = num_lags or h.shape[-1] - nl + 1
    w0, wl = _window_block(mesh, -(-total_lags // m))
    ef, el, auto_lag = _exclusions(n[None], freqs, fs, exclude_freq,
                                   exclude_lag)
    guard, rescore_win = _rescore_guards(nl, auto_lag, h.shape[-1])
    p = int(num_peaks)
    num_bins = len(freqs) if use_banded else None
    out_freqs = freqs_pad if use_banded else freqs
    ns_k = n[None] if use_banded else pad_to(n[None], nl + (-nl) % SUPER)
    ops, b, sup, modes = _shard_operands(
        ns_k, h[None], _tensor(centers, mesh) if use_banded else None,
        _tensor(rel, mesh), fs, m, d, w0, wl, total_lags)
    v1, i1, v2, i2 = _coarse_rank(*ops, b, sup, m, want_top2=True, sep=el,
                                  **modes)
    kb, s = len(rel), modes["share_h"]
    dev = mesh.device
    woff = (w0 + torch.arange(wl, dtype=torch.int32, device=dev)) * m
    vals_j = torch.stack([v1, v2], dim=-1).reshape(kb, s, wl, 2)
    lags_j = (torch.stack([i1, i2], dim=-1).reshape(kb, s, wl, 2)
              + woff[:, None])
    vals_j = torch.where(lags_j < total_lags, vals_j, -1.0)
    vals_j = vals_j.permute(1, 2, 0, 3)                     # (S, wl, Kb, 2)
    lags_j = lags_j.permute(1, 2, 0, 3)
    wlat = _lattice_from_bin_candidates(
        vals_j, lags_j, p, ef, el,
        bin_offset=(torch.arange(s, device=dev) * kb)[:, None],
        num_bins=num_bins)
    local = merge_peaks(CafPeak(*(f.reshape(-1) for f in wlat)), p, ef, el)
    lat = global_peaks(local, AXIS_TIME, p, ef, el, mesh=mesh)
    # Candidate slots per global bin, gathered window-major: (S*Kb, W*2).
    vflat, lflat = (torch.movedim(x, 0, 1).reshape(s * kb, -1)
                    for x in all_gather_fields(
                        [x.permute(0, 2, 1, 3).reshape(s * kb, -1)
                         for x in (vals_j, lags_j)], AXIS_TIME, mesh=mesh))
    if num_bins is not None:
        vflat = torch.where(torch.arange(s * kb, device=dev)[:, None]
                            < num_bins, vflat, -1.0)
    lat1 = CafPeak(*(f[None] for f in lat))
    vals_e, bins_e, lags_e = _rescore_entries_windowed(
        n[None], h[None], _tensor(out_freqs, mesh), vflat[None],
        lflat[None], lat1, fs, m, total_lags, guard, rescore_win, el, ef)
    pk = merge_peaks(CafPeak(vals_e[0], bins_e[0], lags_e[0]), p, ef, el)
    if min_snr_db is None and not with_snr:
        return _host(out_freqs, pk)
    floor = float(_stein_model_floor(n.cpu().numpy()[None],
                                     h.cpu().numpy()[None])[0])
    return detection_rows(out_freqs, pk, floor, len(freqs) * total_lags,
                          min_snr_db, with_snr)


def sharded_batched_stein_os_peaks(needles, haystacks, freqs_hz,
                                   sample_rate, mesh: Mesh, num_peaks: int,
                                   num_lags: Optional[int] = None, *,
                                   block_len: int = 64,
                                   exclude_freq: Optional[int] = None,
                                   exclude_lag: Optional[int] = None,
                                   backend: Optional[str] = None,
                                   min_snr_db=None, with_snr: bool = False):
    """Top-``num_peaks`` emitters PER PAIR of long captures, FUSED
    windowed engine (plain or banded, K1 (d+e) / (c+d+e)), pairs sharded
    over ``pair`` — the single-device
    :func:`~caf_cookoff_tpu_torch.models.batched_stein.
    batched_stein_os_peaks` on each rank's pairs, gathered.  Returns
    ``(freqs (B, P), lags (B, P), values (B, P)[, snr_db])``."""
    resolve_backend(backend)
    ns, hs = _pair_batch(needles, haystacks, mesh, equal=False)
    n = ns.shape[-1]
    if hs.shape[-1] <= n:
        raise ValueError(
            "use sharded_batched_stein_peaks for equal-length pairs")
    freqs = signal_grid(freqs_hz, ns)
    fs = float(sample_rate)
    try:
        use_banded, d, freqs_pad, centers, rel = _windowed_route(
            fs, freqs, lambda: _pow2_block_len(fs, freqs, block_len))
    except SpanError:
        raise EligibilityError(_NO_ROUTE % "batched_overlap_save_peaks "
                               "(the lattice scan)") from None
    m = xcor_length(n)
    total_lags = num_lags or hs.shape[-1] - n + 1
    ef, el, auto_lag = _exclusions(ns, freqs, fs, exclude_freq, exclude_lag)
    guard, rescore_win = _rescore_guards(n, auto_lag, hs.shape[-1])
    out_freqs = freqs_pad if use_banded else freqs
    pk = _stein_os_peaks(
        _shard(ns, mesh, AXIS_PAIR), _shard(hs, mesh, AXIS_PAIR),
        _tensor(out_freqs, mesh),
        _tensor(centers, mesh) if use_banded else None, _tensor(rel, mesh),
        fs, m, d, -(-total_lags // m), total_lags, int(num_peaks), ef, el,
        guard, rescore_win, num_bins=len(freqs) if use_banded else None)
    pk = CafPeak(*_gather_pairs(mesh, *pk))
    if min_snr_db is None and not with_snr:
        return _host(out_freqs, pk)
    return detection_rows(out_freqs, pk,
                          _stein_model_floor(ns.cpu().numpy(),
                                             hs.cpu().numpy()),
                          len(freqs) * total_lags, min_snr_db, with_snr)


def sharded_stein_rate_os_peak(needle, haystack, freqs_hz, rates_hz_per_s,
                               sample_rate, mesh: Mesh,
                               num_lags: Optional[int] = None, *,
                               block_len: int = 64,
                               backend: Optional[str] = None
                               ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag, value): the SEGMENTED rate search
    (:func:`caf_cookoff_tpu_torch.models.rate.stein_rate_os_peak`, trial
    rates as K1 (f) synthesis rows) with its window axis sharded over
    ``time``.  The (R, K) coarse maxima gather over ``time`` in window
    order, so answers equal the single-device segmented engine's; the
    serial dechirp-bank mesh engine
    (:func:`sharded_rate_overlap_save_peak`) takes the grids and rates
    outside the segmented envelope."""
    resolve_backend(backend)
    fs = float(sample_rate)
    (n, h, freqs, rates, total_lags, d, freqs_pad, centers, rel, guard, m,
     windows) = _segmented_inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                  fs, num_lags, block_len, mesh.device)
    w0, wl = _window_block(mesh, windows)
    vals, idxs = _rate_ranks(n, h[w0 * m:], centers, rel, rates, fs, d, m,
                             wl, total_lags - w0 * m)       # (R, Kb, S, wl)
    glob = idxs + (w0 + torch.arange(wl, dtype=torch.int32,
                                     device=n.device)) * m
    vals = torch.where((glob < total_lags) & (vals >= 0), vals, -math.inf)
    wbest = torch.argmax(vals, dim=-1, keepdim=True)
    rowmax, rowlag = (torch.gather(x, -1, wbest)[..., 0].permute(0, 2, 1)
                      .reshape(len(rates), -1) for x in (vals, glob))
    rowmax, rowlag = _time_best(rowmax, rowlag, mesh)
    r_i, value, f_i, lag = _rate_coarse_closer(
        n, h, _tensor(freqs_pad, mesh), rates, rowmax, rowlag, fs, m,
        total_lags, guard, len(freqs))
    return float(rates[r_i]), float(freqs_pad[f_i]), lag, value


# ---------------------------------------------------------------------------
# Pair/doppler/time-sharded serial RATE engines (rates over ``pair``)
# ---------------------------------------------------------------------------


def _rate_os_inputs(needle, haystack, freqs_hz, rates_hz_per_s, mesh: Mesh,
                    num_lags):
    (n, _, total_lags, chunk, local, halo, offset, freqs, freqs_p, loc,
     k0) = _os_inputs(needle, haystack, freqs_hz, mesh, num_lags)
    rates = np.asarray(rates_hz_per_s, dtype=freqs.dtype).reshape(-1)
    # Rates shard over the pair axis; pad duplicates of the LAST rate
    # lose every lowest-rate-index tie-break.
    rates_p = pad_axis_to(rates, mesh.shape[AXIS_PAIR])
    r_loc = len(rates_p) // mesh.shape[AXIS_PAIR]
    r_base = mesh.axis_index(AXIS_PAIR) * r_loc
    return (n, total_lags, chunk, local, halo, offset, freqs, freqs_p, loc,
            k0, rates, rates_p, r_base, rates_p[r_base:r_base + r_loc])


def _rate_shard_scan(n, loc, local_rates, fs, chunk, local, halo, offset,
                     total_lags, **kw):
    """Every local trial rate's deferred-halo scan, the rates riding the
    scan's leading axis in slices of the serial engines' batch."""
    nl = n.shape[-1]
    m, _, _ = plan_blocks(nl, chunk)
    outs = []
    for sl in _rate_batches(len(local_rates), loc.shape[0] * m):
        s_conj = needle_spectra_conj(_prechirp(n, local_rates[sl], fs), loc,
                                     fs, m)
        outs.append(streaming_peak_deferred_halo(
            s_conj, local, halo, nl, chunk, offset, total_lags, None, **kw))
    return outs


def sharded_rate_overlap_save_peak(needle, haystack, freqs_hz,
                                   rates_hz_per_s, sample_rate, mesh: Mesh,
                                   num_lags: Optional[int] = None, *,
                                   backend: str = "matmul"
                                   ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag, value): the joint (rate, doppler,
    lag) search of :func:`caf_cookoff_tpu_torch.models.rate.
    rate_overlap_save_peak` with the trial rates over ``pair`` (padded
    by repeating the last), bins over ``doppler`` and lag chunks over
    ``time``; every trial rate reuses the one halo slice, and the
    per-rank best (rate, value, freq, lag) reduces over all three axes
    (:func:`global_rate_peak`: earliest rate, then row-major)."""
    quad, rates_p, freqs_p = _rate_os_peak_shard(
        needle, haystack, freqs_hz, rates_hz_per_s, sample_rate, mesh,
        num_lags, backend)
    val, r_idx, f_idx, lag = global_rate_peak(*quad, _ALL, mesh=mesh)
    return (float(rates_p[int(r_idx)]), float(freqs_p[int(f_idx)]),
            int(lag), float(val))


def _rate_os_peak_shard(needle, haystack, freqs_hz, rates_hz_per_s,
                        sample_rate, mesh: Mesh, num_lags, backend):
    """This rank's share of :func:`sharded_rate_overlap_save_peak`, no
    collective: ((value, rate, freq, lag) of its best, global indices;
    the padded rates; the padded grid)."""
    resolve_backend(backend)
    (n, total_lags, chunk, local, halo, offset, _, freqs_p, loc, k0, _,
     rates_p, r_base, local_rates) = _rate_os_inputs(
        needle, haystack, freqs_hz, rates_hz_per_s, mesh, num_lags)
    fs = float(sample_rate)
    pk = CafPeak(*(torch.cat(f) for f in zip(*_rate_shard_scan(
        n, loc, local_rates, fs, chunk, local, halo, offset, total_lags))))
    i = int(torch.argmax(pk.value))          # first max: earliest rate
    return ((pk.value[i], torch.tensor(r_base + i, device=mesh.device),
             pk.freq_idx[i] + k0, pk.lag_idx[i]), rates_p, freqs_p)


def sharded_rate_overlap_save_peaks(needle, haystack, freqs_hz,
                                    rates_hz_per_s, sample_rate,
                                    mesh: Mesh, num_peaks: int,
                                    num_lags: Optional[int] = None, *,
                                    exclude_freq: Optional[int] = None,
                                    exclude_lag: Optional[int] = None,
                                    backend: str = "matmul",
                                    min_snr_db=None,
                                    with_snr: bool = False):
    """Top-``num_peaks`` accelerating emitters of a sharded long capture
    — :func:`caf_cookoff_tpu_torch.models.rate.rate_overlap_save_peaks`'
    semantics (window-centre-keyed cross-rate merge, rate-aware NMS,
    detection over ``R*K*num_lags`` cells against the summed global
    floor).  Each rank folds its local rates' lattices in rate order;
    the rank lattices meet in :func:`global_rate_peaks` over all three
    axes.  Emitters at DISTINCT lags match the single-device engine;
    slots at a strong emitter's own lag cell may differ (hierarchical
    NMS, the JAX package's contract).  Returns ``(rates (P,), freqs
    (P,), lags (P,), values (P,)[, snr_db (P,)])``."""
    resolve_backend(backend)
    (n, total_lags, chunk, local, halo, offset, freqs, freqs_p, loc, k0,
     rates, rates_p, r_base, local_rates) = _rate_os_inputs(
        needle, haystack, freqs_hz, rates_hz_per_s, mesh, num_lags)
    fs = float(sample_rate)
    nl = n.shape[-1]
    ef, el = resolve_exclusions(n, freqs, fs, exclude_freq, exclude_lag)
    htb = _rate_grid_half_t_bins(freqs, nl, fs)
    htb_c = rates.dtype.type(htb)
    p = int(num_peaks)
    want_floor = with_snr or min_snr_db is not None
    rows = k0 + torch.arange(len(loc), device=mesh.device)
    outs = _rate_shard_scan(n, loc, local_rates, fs, chunk, local, halo,
                            offset, total_lags, num_peaks=p, exclude_freq=ef,
                            exclude_lag=el, valid_rows=rows < len(freqs),
                            with_floor=want_floor)
    if want_floor:
        pk = CafPeak(*(torch.cat(f) for f in zip(*(o[0] for o in outs))))
        fsums = torch.cat([o[1] for o in outs]).cpu().numpy()
        fcnts = torch.cat([o[2] for o in outs]).cpu().numpy()
    else:
        pk = CafPeak(*(torch.cat(f) for f in zip(*outs)))
    if p == 1:
        pk = as_lattice(pk)
    vals, bins, lags = (x.cpu().numpy() for x in pk)          # (R_loc, P)
    lat = (np.full(p, -np.inf, vals.dtype),
           *(np.zeros(p, np.int32) for _ in range(4)),
           np.zeros(p, rates.dtype))
    fsum = fcnt = rates.dtype.type(0)
    for i, r in enumerate(local_rates):
        r_idx = r_base + i
        if want_floor and r_idx < len(rates):
            # Pad-duplicated rates must not count their cells twice.
            fsum, fcnt = fsum + fsums[i], fcnt + fcnts[i]
        f_g = bins[i] + k0
        lat = _merge_rate_lattice(
            np.concatenate([lat[0], vals[i]]),
            np.concatenate([lat[1], f_g + np.round(r * htb_c).astype(
                np.int32)]),
            np.concatenate([lat[2], lags[i]]),
            np.concatenate([lat[3], np.full(p, r_idx, np.int32)]),
            np.concatenate([lat[4], f_g]),
            np.concatenate([lat[5], np.full(p, r, rates.dtype)]),
            p, ef, el, htb_c)
    g_vals, _, g_lags, g_ridx, g_fws, _ = global_rate_peaks(
        torch.from_numpy(lat[0]), *(torch.from_numpy(x) for x in lat[1:5]),
        rates_p, _ALL, p, ef, el, htb_c, mesh=mesh)
    out_rates = rates_p.astype(np.float64)[g_ridx]
    out_freqs = np.asarray(freqs_p, np.float64)[g_fws]
    if not want_floor:
        return out_rates, out_freqs, g_lags, g_vals
    fsum, fcnt = (all_reduce(torch.tensor(x), ReduceOp.SUM,
                             _ALL, mesh=mesh) for x in (fsum, fcnt))
    vals, snr, _ = apply_detection_threshold(
        g_vals, mean_floor(fsum, fcnt), len(rates) * len(freqs) * total_lags,
        min_snr_db)
    return (out_rates, out_freqs, g_lags, vals) + ((snr,) if with_snr
                                                   else ())
