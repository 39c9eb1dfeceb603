"""Second-order CAF: the joint (rate, doppler, lag) search.

An emitter whose doppler sweeps at ``r`` Hz/s smears across the
first-order surface.  The rate axis is a dechirp bank: pre-chirping the
needle by ``e^{+j pi r t^2}`` makes a swept copy correlate coherently at
its window-start frequency (shifts compose), so each trial rate is one
more filterbank or overlap-save pass (:func:`rate_caf_peak`,
:func:`rate_overlap_save_peak[s] <rate_overlap_save_peaks>`, the serial
engines, on ``torch.fft``).

The segmented engines (:func:`stein_rate_os_peak`,
:func:`stein_rate_os_peaks`) fold the rate axis into K1's synthesis
rows instead (K1 mode (f), :func:`~caf_cookoff_tpu_torch.ops.fused_stein.
stein_rate_synthesis_weights`): stage A, the segment correlations, is
shared by every (rate, doppler) row, so the whole (rate, doppler, lag)
volume is one kernel launch.  Top candidates are then re-scored exactly
with their own pre-chirped needles on a guard-extended capture slice.

Port of ``caf_cookoff_tpu/models/rate.py``: the same answers and
tie-breaks (earlier rate, then lower bin, then lower lag), the JAX
``lax.scan`` folds in rate order.  The cross-rate lattice merges run on
the host in numpy: they see a few dozen candidates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (floor_pow2, resolve_backend,
                                          signal_grid, xcor_length)
from caf_cookoff_tpu_torch.errors import SpanError
from caf_cookoff_tpu_torch.models._stein_plan import (_as_tensor,
                                                      _auto_block_len,
                                                      _windowed_route)
from caf_cookoff_tpu_torch.models.batched_stein import (
    _coarse_rank, _exclusions, _lattice_from_bin_candidates, _os_operands,
    _rescore_entries_windowed, _rescore_guards, _stein_model_floor)
from caf_cookoff_tpu_torch.models.overlap_save import (mean_floor,
                                                       needle_spectra_conj,
                                                       plan_blocks,
                                                       streaming_peak)
from caf_cookoff_tpu_torch.models.stein import _prep_long
from caf_cookoff_tpu_torch.ops.fused_stein import (LAG_TILE, SUPER,
                                                   stein_rate_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, apply_detection_threshold,
                                            as_lattice, doppler_cell_bins,
                                            find_peak_2d, merge_peaks,
                                            resolve_exclusions, topk_separated)
from caf_cookoff_tpu_torch.ops.shift import real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2, pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal

# Serial engines: (rate, bin, lag) cells a batched pass over several trial
# rates may hold (complex64: 2 GiB per live buffer at the cap).
_BANK_CELLS = 1 << 28
# Segmented engines: bytes of K1's per-128-lag-tile partials (value + lag,
# 8 B per (program, row, tile)) one launch may write.  The partials are
# what grows with the synthesis rows on Hopper (the TPU kernel's limit,
# VMEM spill slots, does not exist here); every extra launch repeats
# stage A (15 GFLOP at the rate3 shape).  1 GiB is 1.3% of the card's
# memory and holds ~120 trial rates of 306-bin bands x 56 programs x
# 8192 lags (8.8 MB a rate), so real rate grids take one launch.
_RATE_PARTIALS_BUDGET = 1 << 30


def _prechirp(needle: torch.Tensor, rates, sample_rate) -> torch.Tensor:
    """(R, N) needles pre-chirped by each trial rate,
    ``n[t] e^{+j pi r (t/fs)^2}``: the phase in the needle's real dtype,
    in the JAX package's order."""
    rdtype = real_dtype_of(needle.dtype)
    dev = needle.device
    t = (torch.arange(needle.shape[-1], dtype=rdtype, device=dev)
         / torch.tensor(sample_rate, dtype=rdtype, device=dev))
    r = torch.as_tensor(rates, dtype=rdtype, device=dev).reshape(-1)
    ph = (math.pi * r)[:, None] * (t * t)[None, :]
    c, s = torch.cos(ph), torch.sin(ph)
    nr, ni = needle.real[None, :], needle.imag[None, :]
    return torch.complex(nr * c - ni * s, nr * s + ni * c)


def _inputs(needle, haystack, freqs_hz, rates_hz_per_s, device):
    """The long-capture engines' inputs: signals on the device, the grid
    and the trial rates in the needle's real dtype."""
    n, h, freqs, _ = _prep_long(needle, haystack, freqs_hz, device)
    return n, h, freqs, np.asarray(rates_hz_per_s,
                                   dtype=freqs.dtype).reshape(-1)


def _rate_batches(num_rates: int, cells_per_rate: int):
    """Consecutive rate slices of the serial engines' batched passes."""
    step = max(1, _BANK_CELLS // max(cells_per_rate, 1))
    return [slice(r0, min(r0 + step, num_rates))
            for r0 in range(0, num_rates, step)]


def rate_caf_peak(needle, haystack, freqs_hz, rates_hz_per_s, sample_rate,
                  *, backend: Optional[str] = None, device=None
                  ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_idx, value): dechirp-bank CAF peak of
    a needle-length window (the lag is a circular xcor index).

    Each trial rate pre-chirps the needle and runs the filterbank rows
    (``torch.fft``); the first rate with the highest peak wins.
    Frequencies use the window-start convention, like
    :func:`~caf_cookoff_tpu_torch.ops.refine.refine_peak_rate`.  Every
    FFT ``backend`` name runs ``torch.fft``."""
    resolve_backend(backend)
    n = as_signal(needle, device)
    h = as_signal(haystack, n.device).to(n.dtype)
    freqs = signal_grid(freqs_hz, n)
    rates = np.asarray(rates_hz_per_s, dtype=freqs.dtype).reshape(-1)
    fs = float(sample_rate)
    m = xcor_length(n.shape[-1])
    freqs_t = torch.from_numpy(freqs).to(n.device)
    parts = [find_peak_2d(mag2(_surface_rows(_prechirp(n, rates[sl], fs), h,
                                             freqs_t, fs, m)))
             for sl in _rate_batches(len(rates), len(freqs) * m)]
    pk = CafPeak(*(torch.cat(f) for f in zip(*parts)))       # fields (R,)
    r = int(torch.argmax(pk.value))                           # first max
    return (float(rates[r]), float(freqs[int(pk.freq_idx[r])]),
            int(pk.lag_idx[r]), float(pk.value[r]))


def _rate_scan(n, h, freqs_t, rates, sample_rate, num_lags: int,
               num_peaks: int = 1, exclude_freq=None, exclude_lag=None,
               with_floor: bool = False):
    """Every trial rate's overlap-save scan (the rates of a batch ride the
    scan's leading axis): fields (R,) — (R, num_peaks) for a lattice —
    and, with ``with_floor``, (R,) floor sums and counts."""
    nl = n.shape[-1]
    m, _, _ = plan_blocks(nl, num_lags)
    peaks, fsums, fcnts = [], [], []
    for sl in _rate_batches(len(rates), freqs_t.shape[0] * m):
        s_conj = needle_spectra_conj(_prechirp(n, rates[sl], sample_rate),
                                     freqs_t, sample_rate, m)
        out = streaming_peak(s_conj, h, nl, num_lags, num_peaks=num_peaks,
                             exclude_freq=exclude_freq,
                             exclude_lag=exclude_lag, with_floor=with_floor)
        if with_floor:
            out, fsum, fcnt = out
            fsums.append(fsum)
            fcnts.append(fcnt)
        peaks.append(out)
    pk = CafPeak(*(torch.cat(f) for f in zip(*peaks)))
    if not with_floor:
        return pk
    return pk, torch.cat(fsums), torch.cat(fcnts)


def rate_overlap_save_peak(needle, haystack, freqs_hz, rates_hz_per_s,
                           sample_rate, num_lags: Optional[int] = None, *,
                           backend: Optional[str] = None, device=None
                           ) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_samples, value) of a long capture:
    the dechirp bank composed with the overlap-save block scan (the
    serial engine, on ``torch.fft``).  Frequencies use the window-start
    convention, lags are absolute capture offsets, the earlier rate wins
    ties (the JAX scan's strict ``>``)."""
    resolve_backend(backend)
    n, h, freqs, rates = _inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                 device)
    lags = num_lags or h.shape[-1] - n.shape[-1] + 1
    pk = _rate_scan(n, h, torch.from_numpy(freqs).to(n.device), rates,
                    float(sample_rate), lags)
    r = int(torch.argmax(pk.value))
    return (float(rates[r]), float(freqs[int(pk.freq_idx[r])]),
            int(pk.lag_idx[r]), float(pk.value[r]))


def _merge_rate_lattice(v, key, lag, ridx, fws, rvals, num_peaks: int,
                        exclude_freq: int, exclude_lag: int, half_t_bins):
    """Greedy NMS over (window-centre key, lag) with a rate-aware window
    (host numpy; the JAX package's ``_merge_rate_lattice``).

    A swept emitter shows at every trial rate ``r'`` with the same
    window-centre frequency, smeared over a residual-chirp ridge of
    half-extent ``|r - r'| T / 2`` Hz, so candidates merge in centre
    frequency space (``key``) and the window between two candidates
    widens by their rates' ridge extent, plus one exclusion cell for
    cross-rate pairs.  Order ``lexsort((lag, key, -v))``; a candidate is
    kept when valid and not close to an earlier kept one.  Returns six
    (num_peaks,) arrays (value, key, lag, rate index, window-start bin,
    rate); unfilled slots are (-inf, 0, 0, 0, 0, 0.0)."""
    v = np.asarray(v)
    rvals = np.asarray(rvals)
    key, lag, ridx, fws = (np.asarray(x, np.int64)
                           for x in (key, lag, ridx, fws))
    order = np.lexsort((lag, key, -v))
    v, key, lag, ridx, fws, rvals = (x[order] for x in
                                     (v, key, lag, ridx, fws, rvals))
    htb = rvals.dtype.type(half_t_bins)
    ridge = np.ceil(np.abs(rvals[:, None] - rvals[None, :])
                    * htb).astype(np.int64)
    margin = np.where(ridge > 0, exclude_freq, 0)
    close = ((np.abs(key[:, None] - key[None, :])
              <= exclude_freq + ridge + margin)
             & (np.abs(lag[:, None] - lag[None, :]) <= exclude_lag))
    kept = np.zeros(v.shape[0], bool)
    for i in range(v.shape[0]):
        kept[i] = v[i] > -np.inf and not np.any(kept[:i] & close[:i, i])
    sel = np.flatnonzero(kept)[:num_peaks]
    out_v = np.full(num_peaks, -np.inf, v.dtype)
    out_v[:len(sel)] = v[sel]
    ints = []
    for x in (key, lag, ridx, fws):
        col = np.zeros(num_peaks, np.int32)
        col[:len(sel)] = x[sel]
        ints.append(col)
    out_r = np.zeros(num_peaks, rvals.dtype)
    out_r[:len(sel)] = rvals[sel]
    return (out_v, *ints, out_r)


def _rate_grid_half_t_bins(freqs_np, needle_len: int,
                           sample_rate) -> float:
    """Centre-key factor ``T / (2 df)`` (grid bins per unit rate):
    ``key = f_ws_bin + round(r * half_t_bins)``, from the host grid."""
    freqs_np = np.asarray(freqs_np, np.float64).reshape(-1)
    t_win = needle_len / float(sample_rate)
    if freqs_np.shape[0] > 1:
        df = float(np.min(np.abs(np.diff(freqs_np))))
    else:
        df = float(sample_rate) / needle_len
    return t_win / (2.0 * max(df, 1e-30))


def _rate_lattice_fold(pk: CafPeak, rates: np.ndarray, num_peaks: int,
                       exclude_freq: int, exclude_lag: int, half_t_bins):
    """The JAX scan over rates: each rate's (num_peaks,) lattice merged
    into the carry in rate order (window-centre keys); returns
    :func:`_merge_rate_lattice`'s six arrays."""
    p = num_peaks
    vals, bins, lags = (x.cpu().numpy() for x in pk)         # (R, p)
    htb = rates.dtype.type(half_t_bins)
    lat = (np.full(p, -np.inf, vals.dtype), *(np.zeros(p, np.int32)
                                              for _ in range(4)),
           np.zeros(p, rates.dtype))
    for i, r in enumerate(rates):
        off = np.round(r * htb).astype(np.int32)
        lat = _merge_rate_lattice(
            np.concatenate([lat[0], vals[i]]),
            np.concatenate([lat[1], bins[i] + off]),
            np.concatenate([lat[2], lags[i]]),
            np.concatenate([lat[3], np.full(p, i, np.int32)]),
            np.concatenate([lat[4], bins[i]]),
            np.concatenate([lat[5], np.full(p, r, rates.dtype)]),
            p, exclude_freq, exclude_lag, htb)
    return lat


def rate_overlap_save_peaks(needle, haystack, freqs_hz, rates_hz_per_s,
                            sample_rate, num_peaks: int,
                            num_lags: Optional[int] = None, *,
                            exclude_freq: Optional[int] = None,
                            exclude_lag: Optional[int] = None,
                            backend: Optional[str] = None,
                            min_snr_db=None, with_snr: bool = False,
                            device=None):
    """Top-``num_peaks`` accelerating emitters of a long capture (the
    serial engine): each trial rate's lattice scan, merged across rates
    in window-centre frequency space with a rate-aware window
    (:func:`_merge_rate_lattice`), so a strong emitter's residual-chirp
    ridge at mismatched rates cannot displace a weaker real one.

    ``min_snr_db`` / ``with_snr`` threshold against the mean |.|^2 over
    every searched cell of every trial rate (``R*K*num_lags`` cells).
    Returns ``(rates, freqs, lags, values[, snr_db])`` numpy arrays,
    strongest first, empty or sub-threshold slots -inf."""
    resolve_backend(backend)
    n, h, freqs, rates = _inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                 device)
    nl = n.shape[-1]
    fs = float(sample_rate)
    lags = num_lags or h.shape[-1] - nl + 1
    ef, el = resolve_exclusions(n, freqs, fs, exclude_freq, exclude_lag)
    p = int(num_peaks)
    want_floor = with_snr or min_snr_db is not None
    out = _rate_scan(n, h, torch.from_numpy(freqs).to(n.device), rates, fs,
                     lags, num_peaks=p, exclude_freq=ef, exclude_lag=el,
                     with_floor=want_floor)
    pk = out[0] if want_floor else out
    if p == 1:
        pk = as_lattice(pk)
    vals, _, lag_idx, ridx, fws, _ = _rate_lattice_fold(
        pk, rates, p, ef, el, _rate_grid_half_t_bins(freqs, nl, fs))
    out_rates = rates.astype(np.float64)[ridx]
    out_freqs = np.asarray(freqs, np.float64)[fws]
    if not want_floor:
        return out_rates, out_freqs, lag_idx, vals
    # The JAX scan adds the rates' sums one after another in f32.
    fsum = fcnt = rates.dtype.type(0)
    for s, c in zip(out[1].cpu().numpy(), out[2].cpu().numpy()):
        fsum, fcnt = fsum + s, fcnt + c
    vals, snr, _ = apply_detection_threshold(
        vals, mean_floor(fsum, fcnt), len(rates) * len(freqs) * lags,
        min_snr_db)
    return (out_rates, out_freqs, lag_idx, vals) + ((snr,) if with_snr
                                                    else ())


# ---------------------------------------------------------------------------
# Segmented rate search: the rate axis as K1's synthesis rows (mode (f))
# ---------------------------------------------------------------------------


def _rate_block_len(sample_rate, freqs_np, rates_np, needle_len: int,
                    requested: int) -> int:
    """Block length under the rate-augmented envelope: a trial rate adds
    a within-block frequency of up to ``|r|_max * T`` to the doppler span
    and a quadratic residual ``pi |r| (D/fs)^2`` (kept under pi/2)."""
    fs = float(sample_rate)
    t_win = needle_len / fs
    r_max = float(np.max(np.abs(rates_np))) if len(rates_np) else 0.0
    f_aug = float(np.max(np.abs(freqs_np))) + r_max * t_win
    d = _auto_block_len(fs, np.asarray([f_aug]), requested)
    if r_max > 0:
        # pi * r * (D/fs)^2 <= pi/2  ->  D <= fs / sqrt(2 r)
        d = min(d, int(fs / np.sqrt(2.0 * r_max)))
    d = floor_pow2(min(d, SUPER))
    if d < 8:
        raise SpanError(
            f"rate-augmented span +-{f_aug:.0f} Hz needs segment length "
            "< 8 — the segmented rate engine does not pay off; use "
            "rate_overlap_save_peak (exact serial scan)")
    return d


def _rate_routing(sample_rate, freqs, rates, needle_len: int,
                  block_len: int, hay_len: int):
    """The segmented rate engines' preamble: the rate-drift margin and
    quadratic cap, the windowed route under them (its ``SpanError`` when
    neither route is eligible), and the re-score guard.  Returns ``(d,
    freqs_pad, centers, rel, guard)``; rows per launch come from
    :func:`_rate_chunk`."""
    fs = float(sample_rate)
    n = needle_len
    r_max = float(np.max(np.abs(rates))) if len(rates) else 0.0
    margin = r_max * (n / fs)
    d_quad = int(fs / np.sqrt(2.0 * r_max)) if r_max > 0 else None
    _, d, freqs_pad, centers, rel = _windowed_route(
        fs, freqs, lambda: _rate_block_len(sample_rate, freqs, rates, n,
                                           block_len),
        margin_hz=margin, d_cap=d_quad)
    guard = min(64, n // 4, max((hay_len - n) // 2, 1))
    return d, freqs_pad, centers, rel, guard


def _rate_chunk(kb: int, programs: int, num_lags: int) -> int:
    """Trial rates per K1 launch: as many as keep the per-tile partials
    (``programs x rows x m_pad/128 x 8 B``) within
    ``_RATE_PARTIALS_BUDGET``.  Rows are independent, so the answers do
    not depend on it."""
    tiles = -(-num_lags // LAG_TILE)
    return max(1, _RATE_PARTIALS_BUDGET // (kb * programs * tiles * 8))


def _rate_ranks(n, h, centers, rel, rates, sample_rate, d: int, v: int,
                windows: int, total_lags: int, sep: Optional[int] = None):
    """K1 over every (rate, band, window): the banded windowed operands
    (the plain route is the one-band case, ``centers=[0]``), rate-major
    synthesis rows in launches of :func:`_rate_chunk` rates.  Returns
    K1's fields, each (R, Kb, S, W) with window-local lags: (values,
    lags), or with ``sep`` (top-2 mode) slot 2's as well."""
    dev = n.device
    rel_t = _as_tensor(rel, dev)
    ops, b, sup, modes = _os_operands(n[None], h[None],
                                      _as_tensor(centers, dev), rel_t,
                                      sample_rate, v, d, windows, total_lags)
    lmat, h_ext = ops[2:]
    kb, s = len(rel), modes["share_h"]
    step = _rate_chunk(kb, s * windows, v)
    parts = []
    for r0 in range(0, len(rates), step):
        rc = rates[r0:r0 + step]
        ws1, ws2 = stein_rate_synthesis_weights(rel_t, rc, sample_rate, b, d)
        out = _coarse_rank(ws1, ws2, lmat, h_ext, b, sup, v,
                           want_top2=sep is not None, sep=sep or 0, **modes)
        parts.append([x.reshape(len(rc), kb, s, windows) for x in out])
    return [torch.cat(f) for f in zip(*parts)]


def _rate_coarse_closer(n, h, freqs_pad, rates, rowmax, rowlag, sample_rate,
                        v: int, total_lags: int, guard: int, num_bins: int):
    """Rank-then-score closer of :func:`stein_rate_os_peak`: pad bins
    out, the hybrid candidate set (global top-8 over (rate, bin), the
    winning rate's mainlobe-separated top-4, every rate's own best),
    each candidate re-scored exactly with its own pre-chirped needle on
    a guard window, and the serial engine's tie-break (earlier rate,
    then lower bin, then lower lag).  Returns (rate index, value, bin,
    lag)."""
    nl = n.shape[-1]
    dev = n.device
    k = freqs_pad.shape[0]
    num_rates = rowmax.shape[0]
    rowmax = torch.where(torch.arange(k, device=dev)[None, :] < num_bins,
                         rowmax, -math.inf)
    flat = rowmax.reshape(-1)
    cand8 = torch.sort(flat, descending=True, stable=True
                       ).indices[:min(8, flat.numel())]
    r0 = cand8[0] // k
    sep = doppler_cell_bins(freqs_pad, nl, sample_rate)
    cand_sep = topk_separated(rowmax[r0], min(4, k), sep) + r0 * k
    per_rate = (torch.argmax(rowmax, dim=1)
                + torch.arange(num_rates, device=dev) * k)
    cand = torch.cat([cand8, cand_sep.long(), per_rate])
    r_c, k_c = cand // k, cand % k
    # A -inf coarse entry (a pad bin, a fully masked row) would be scored
    # at a frequency outside the grid: it cannot win.
    cand_ok = torch.isfinite(flat[cand])
    wlen = nl + 2 * guard
    hay = pad_to(h, max(h.shape[-1], wlen))
    start = torch.clamp(rowlag.reshape(-1)[cand].long() - guard, 0,
                        max(h.shape[-1] - wlen, 0))
    windows = hay[start[:, None] + torch.arange(wlen, device=dev)]
    rates_t = torch.as_tensor(rates, device=dev)
    exact = mag2(_surface_rows(_prechirp(n, rates_t[r_c], sample_rate),
                               windows, freqs_pad[k_c][:, None], sample_rate,
                               v))[:, 0]                        # (C, M)
    local = torch.arange(v, device=dev)
    ok = (local <= 2 * guard)[None, :] & (start[:, None] + local < total_lags)
    exact = torch.where(ok, exact, -math.inf)
    vals_e = torch.where(cand_ok, torch.amax(exact, dim=-1), -math.inf)
    lags_e = start + torch.argmax(exact, dim=-1)
    vals_e, lags_e, r_c, k_c = (x.cpu().numpy()
                                for x in (vals_e, lags_e, r_c, k_c))
    best = np.lexsort((lags_e, k_c, r_c, -vals_e))[0]
    return int(r_c[best]), float(vals_e[best]), int(k_c[best]), \
        int(lags_e[best])


def _segmented_inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                      sample_rate, num_lags, block_len, device):
    n, h, freqs, rates = _inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                 device)
    nl = n.shape[-1]
    total_lags = num_lags or h.shape[-1] - nl + 1
    d, freqs_pad, centers, rel, guard = _rate_routing(
        sample_rate, freqs, rates, nl, block_len, h.shape[-1])
    m = xcor_length(nl)
    return (n, h, freqs, rates, total_lags, d, freqs_pad, centers, rel,
            guard, m, -(-total_lags // m))


def stein_rate_os_peak(needle, haystack, freqs_hz, rates_hz_per_s,
                       sample_rate, num_lags: Optional[int] = None, *,
                       block_len: int = 64, backend: Optional[str] = None,
                       device=None) -> Tuple[float, float, int, float]:
    """(rate_hz_per_s, freq_hz, lag_samples, value): the joint (rate,
    doppler, lag) long-capture search through K1 mode (f).

    The contract of :func:`rate_overlap_save_peak` (window-start
    frequencies, absolute lags, earlier-rate tie-break) at one K1 launch
    for the whole (rate, doppler, lag) volume: trial rates are synthesis
    rows over shared segment correlations.  Wide uniform grids band with
    the rate drift folded into the band envelope; grids and rates outside
    every segmented envelope raise ``SpanError`` (use the serial engine).
    On CUDA tensors the rank launches the kernel, on CPU tensors its f32
    plain version.  Every FFT ``backend`` name runs ``torch.fft``."""
    resolve_backend(backend)
    fs = float(sample_rate)
    (n, h, freqs, rates, total_lags, d, freqs_pad, centers, rel, guard, m,
     windows) = _segmented_inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                  fs, num_lags, block_len, device)
    vals, idxs = _rate_ranks(n, h, centers, rel, rates, fs, d, m, windows,
                             total_lags)                    # (R, Kb, S, W)
    glob = idxs + torch.arange(windows, dtype=torch.int32,
                               device=n.device) * m
    vals = torch.where((glob < total_lags) & (vals >= 0), vals, -math.inf)
    wbest = torch.argmax(vals, dim=-1, keepdim=True)
    # Global bin = band*Kb + j on the freqs_pad lattice: (R, S*Kb).
    rowmax, rowlag = (torch.gather(x, -1, wbest)[..., 0].permute(0, 2, 1)
                      .reshape(len(rates), -1) for x in (vals, glob))
    r_i, value, f_i, lag = _rate_coarse_closer(
        n, h, _as_tensor(freqs_pad, n.device), rates, rowmax, rowlag, fs, m,
        total_lags, guard, len(freqs))
    return float(rates[r_i]), float(freqs_pad[f_i]), lag, value


def stein_rate_os_peaks(needle, haystack, freqs_hz, rates_hz_per_s,
                        sample_rate, num_peaks: int,
                        num_lags: Optional[int] = None, *,
                        block_len: int = 64,
                        exclude_freq: Optional[int] = None,
                        exclude_lag: Optional[int] = None,
                        backend: Optional[str] = None, min_snr_db=None,
                        with_snr: bool = False, device=None):
    """Top-``num_peaks`` accelerating emitters of a long capture through
    K1 modes (e) and (f): per-rate NMS lattices from the kernel's top-2
    per-bin candidates, merged across rates in window-centre frequency
    space (:func:`_merge_rate_lattice`), each survivor re-scored exactly
    with its own pre-chirped needle on a guard-extended capture slice,
    then merged again on the exact values.

    :func:`rate_overlap_save_peaks`' semantics; ``min_snr_db``
    thresholds against the model floor ``sum|n|^2 * mean|h|^2`` (the
    dechirp has unit magnitude) over ``R*K*num_lags`` cells.  Returns
    ``(rates, freqs, lags, values[, snr_db])``, strongest first, empty or
    sub-threshold slots -inf."""
    resolve_backend(backend)
    fs = float(sample_rate)
    (n, h, freqs, rates, total_lags, d, freqs_pad, centers, rel, _, m,
     windows) = _segmented_inputs(needle, haystack, freqs_hz, rates_hz_per_s,
                                  fs, num_lags, block_len, device)
    nl, dev, p = n.shape[-1], n.device, int(num_peaks)
    ef, el, auto_lag = _exclusions(n[None], freqs, fs, exclude_freq,
                                   exclude_lag)
    guard, rescore_win = _rescore_guards(nl, auto_lag, h.shape[-1])
    htb = _rate_grid_half_t_bins(freqs, nl, fs)
    v1, i1, v2, i2 = _rate_ranks(n, h, centers, rel, rates, fs, d, m,
                                 windows, total_lags, sep=el)
    num_rates, kb, s = v1.shape[:3]
    woff = torch.arange(windows, dtype=torch.int32, device=dev) * m
    vals_j = torch.stack([v1, v2], dim=-1)                  # (R, Kb, S, W, 2)
    lags_j = torch.stack([i1, i2], dim=-1) + woff[:, None]
    vals_j = torch.where(lags_j < total_lags, vals_j, -1.0)
    # Per-rate lattices: one per (band, window) on global bins, folded.
    wlat = _lattice_from_bin_candidates(
        vals_j.permute(0, 2, 3, 1, 4), lags_j.permute(0, 2, 3, 1, 4), p, ef,
        el, bin_offset=(torch.arange(s, device=dev) * kb)[:, None],
        num_bins=len(freqs))                                # (R, S, W, p)
    rlat = merge_peaks(CafPeak(*(f.reshape(num_rates, -1) for f in wlat)),
                       p, ef, el)                           # (R, p)
    # Each rate's candidate slots on the global lattice: (R, S*Kb, W*2).
    vslots, lslots = (x.permute(0, 2, 1, 3, 4).reshape(num_rates, s * kb, -1)
                      for x in (vals_j, lags_j))
    vslots = torch.where(torch.arange(s * kb, device=dev)[None, :, None]
                         < len(freqs), vslots, -1.0)
    # Cross-rate merge on window-centre keys (coarse values rank only).
    htb_c = rates.dtype.type(htb)
    cv, cb, cl = (x.reshape(-1).cpu().numpy() for x in rlat)
    rv_of = np.repeat(rates, p)
    mv, _, ml, mr, mf, mrv = _merge_rate_lattice(
        cv, cb + np.round(rv_of * htb_c).astype(np.int32), cl,
        np.repeat(np.arange(num_rates, dtype=np.int32), p), cb, rv_of, p,
        ef, el, htb_c)
    # Exact per-entry re-score, each entry with its own rate's needle.
    mr_t = torch.as_tensor(mr, device=dev).long()
    lat = CafPeak(*(torch.as_tensor(x, device=dev)[:, None]
                    for x in (mv, mf, ml)))
    ev, eb, elag = _rescore_entries_windowed(
        _prechirp(n, torch.as_tensor(rates, device=dev)[mr_t], fs),
        h[None].expand(p, -1), _as_tensor(freqs_pad, dev), vslots[mr_t],
        lslots[mr_t], lat, fs, m, total_lags, guard, rescore_win, el, ef)
    ev, eb, elag = (x[:, 0].cpu().numpy() for x in (ev, eb, elag))
    # Re-merge on the exact values (keys from the exact bins).
    vals, _, lags, ridx, fws, _ = _merge_rate_lattice(
        ev, eb + np.round(mrv * htb_c).astype(np.int32), elag, mr, eb, mrv,
        p, ef, el, htb_c)
    out = (rates.astype(np.float64)[ridx],
           np.asarray(freqs_pad, np.float64)[fws], lags, vals)
    if min_snr_db is None and not with_snr:
        return out
    floor = float(_stein_model_floor(n.cpu().numpy()[None],
                                     h.cpu().numpy()[None])[0])
    vals, snr, _ = apply_detection_threshold(
        vals, floor, len(rates) * len(freqs) * total_lags, min_snr_db)
    return out[:3] + (vals,) + ((snr,) if with_snr else ())
