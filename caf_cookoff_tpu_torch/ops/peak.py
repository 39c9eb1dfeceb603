"""Peak extraction over the delay x doppler surface: the single global
peak, and the multi-emitter lattices (non-maximum suppression) with
their detection threshold.

Tie-breaks match the JAX package: ``torch.argmax`` returns the first
maximum (lowest flat index), as ``jnp.argmax`` does, and the lattice
merge orders candidates as ``jnp.lexsort((lag, freq, -value))`` does.
The resolution cell and the detection threshold run on the host in
numpy: they give static ints and host arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.ops.shift import numpy_real


class CafPeak(NamedTuple):
    """Result triple: surface value, frequency-bin index, lag index."""

    value: torch.Tensor      # f32/f64 peak magnitude-squared
    freq_idx: torch.Tensor   # int32 row (doppler bin)
    lag_idx: torch.Tensor    # int32 raw column (circular lag index)


def find_peak_2d(surface: torch.Tensor) -> CafPeak:
    """Global argmax over a (..., K, M) real surface -> (value, k, tau);
    exact ties go to the lowest flat index."""
    k, m = surface.shape[-2], surface.shape[-1]
    flat = surface.reshape(*surface.shape[:-2], k * m)
    flat_idx = torch.argmax(flat, dim=-1)
    value = torch.amax(surface, dim=(-2, -1))
    return CafPeak(value=value,
                   freq_idx=(flat_idx // m).to(torch.int32),
                   lag_idx=(flat_idx % m).to(torch.int32))


def surface_peak(rows_complex: torch.Tensor) -> CafPeak:
    """|.|^2 and the global argmax over complex xcor rows -> (value, k,
    tau), as :func:`find_peak_2d` on the magnitude-squared surface."""
    mag2 = (rows_complex.real * rows_complex.real
            + rows_complex.imag * rows_complex.imag)
    return find_peak_2d(mag2)


def grid_frequency(freq_idx: torch.Tensor,
                   freqs_hz: torch.Tensor) -> torch.Tensor:
    """Look up the physical frequency of a doppler-bin index."""
    return freqs_hz[freq_idx.long()]


def signed_lag(lag_idx: torch.Tensor, xcor_len: int,
               needle_len: int) -> torch.Tensor:
    """Raw circular lag index -> signed sample lag (indices near
    ``xcor_len`` wrap to negative lags)."""
    lag = lag_idx.to(torch.int32)
    return torch.where(lag >= xcor_len - needle_len, lag - xcor_len, lag)


def unwrap_lag(raw_lag: int, xcor_len: int, needle_len: int) -> int:
    """Host-side :func:`signed_lag`."""
    raw_lag = int(raw_lag)
    return raw_lag - xcor_len if raw_lag >= xcor_len - needle_len \
        else raw_lag


def topk_separated(values: torch.Tensor, k: int, sep) -> torch.Tensor:
    """Indices of the top-``k`` entries of a score vector (or of each row
    of a (..., K) batch) with a minimum index separation ``sep`` between
    picks (greedy 1-D NMS).  If fewer than ``k`` separated entries exist
    above ``-inf``, the surplus slots repeat the argmax of an all-``-inf``
    vector (0)."""
    idxs = torch.arange(values.shape[-1], device=values.device)
    vals = values
    picks = []
    for _ in range(k):
        i = torch.argmax(vals, dim=-1, keepdim=True)
        picks.append(i[..., 0])
        vals = torch.where((idxs - i).abs() <= sep,
                           torch.full_like(vals, -float("inf")), vals)
    return torch.stack(picks, dim=-1).to(torch.int32)


def doppler_cell_bins(freqs_hz: torch.Tensor, needle_len: int,
                      sample_rate) -> torch.Tensor:
    """Doppler mainlobe width (fs/N Hz) in bins of the grid (>= 1,
    capped at the grid size), computed in the grid's dtype.  ``fs/N``
    is the IEEE quotient in that dtype, taken in numpy and filled on the
    grid's device (nothing is copied there)."""
    k = freqs_hz.shape[-1]
    step = (freqs_hz[min(1, k - 1)] - freqs_hz[0]).abs()
    step = torch.clamp(step, min=1e-30)
    np_dt = numpy_real(freqs_hz.dtype)
    cell = step.new_full((), float(np_dt(sample_rate) / np_dt(needle_len)))
    return torch.clamp(torch.ceil(cell / step), 1.0,
                       float(k)).to(torch.int32)


def _lag_distance(a, b, lag_period: Optional[int]):
    """|a - b|, circularly when ``lag_period`` is set: on a circular xcor
    lag axis a peak near lag 0 and its wrap-around skirt near ``m - 1``
    are one resolution cell apart, not ``m - 1``."""
    d = (a - b).abs()
    if lag_period is None:
        return d
    return torch.minimum(d, lag_period - d)


def _stack(peaks) -> CafPeak:
    return CafPeak(*(torch.stack(field, dim=-1) for field in zip(*peaks)))


def find_peaks(surface, num_peaks: int, exclude_freq: int,
               exclude_lag: int, lag_period: Optional[int] = None) -> CafPeak:
    """Top-``num_peaks`` peaks of a (..., K, M) surface with non-maximum
    suppression: take the global peak, mask the ``(2*exclude_freq+1) x
    (2*exclude_lag+1)`` window around it to -inf, repeat.  Fields are
    (..., num_peaks), strongest first.  Size the windows to the
    waveform's resolution cell (:func:`resolution_cell`); ``lag_period``
    makes the lag distance circular (equal-length pairs)."""
    surf = torch.as_tensor(surface)
    k, m = surf.shape[-2], surf.shape[-1]
    ki = torch.arange(k, device=surf.device)[:, None]
    ti = torch.arange(m, device=surf.device)[None, :]
    peaks = []
    for _ in range(num_peaks):
        pk = find_peak_2d(surf)
        inside = (((ki - pk.freq_idx[..., None, None]).abs() <= exclude_freq)
                  & (_lag_distance(ti, pk.lag_idx[..., None, None],
                                   lag_period) <= exclude_lag))
        surf = torch.where(inside, torch.full_like(surf, -float("inf")),
                           surf)
        peaks.append(pk)
    return _stack(peaks)


def concat_peaks(a: CafPeak, b: CafPeak) -> CafPeak:
    """Concatenate two candidate lattices along the (last) candidate axis."""
    return CafPeak(*(torch.cat([x, y], dim=-1) for x, y in zip(a, b)))


def as_lattice(pk: CafPeak) -> CafPeak:
    """Lift a single-peak result to a 1-slot lattice (a trailing candidate
    axis), so ``num_peaks=1`` is a valid degenerate lattice."""
    return CafPeak(*(x[..., None] for x in pk))


def merge_peaks(candidates: CafPeak, num_peaks: int, exclude_freq: int,
                exclude_lag: int, return_indices: bool = False,
                lag_period: Optional[int] = None):
    """Greedy NMS merge of ``C`` candidate triples -> top-``num_peaks``,
    batched over leading axes.

    Candidates are ordered by value descending, then (freq_idx, lag_idx)
    ascending (stable sorts in ``jnp.lexsort((lag, freq, -value))``'s
    key order); a candidate is kept when it is valid (value > -inf) and
    not within the exclusion window of an earlier kept one.  Only the
    first ``num_peaks`` kept entries are returned, so the JAX package's
    scan over all C candidates becomes ``num_peaks`` steps: each keeps
    the first surviving candidate and suppresses its cell.  Fields are
    (..., num_peaks); unfilled slots carry -inf / index 0.
    ``return_indices=True`` also returns each kept entry's position in
    the original candidate order (0 for unfilled slots).
    """
    v = torch.as_tensor(candidates.value)
    f = torch.as_tensor(candidates.freq_idx).to(torch.int64)
    lg = torch.as_tensor(candidates.lag_idx).to(torch.int64)
    c = v.shape[-1]
    if c < num_peaks:
        pad = (*v.shape[:-1], num_peaks - c)
        v = torch.cat([v, v.new_full(pad, -float("inf"))], dim=-1)
        f = torch.cat([f, f.new_zeros(pad)], dim=-1)
        lg = torch.cat([lg, lg.new_zeros(pad)], dim=-1)
    order = torch.argsort(lg, dim=-1, stable=True)
    for key in (f, -v):
        order = order.gather(-1, torch.argsort(key.gather(-1, order),
                                               dim=-1, stable=True))
    v, f, lg = (x.gather(-1, order) for x in (v, f, lg))
    alive = v > -float("inf")
    slots = []
    for _ in range(num_peaks):
        filled = alive.any(dim=-1)
        i = torch.argmax(alive.to(torch.int8), dim=-1, keepdim=True)
        vi, fi, li = (x.gather(-1, i) for x in (v, f, lg))
        alive = alive & ~(((f - fi).abs() <= exclude_freq)
                          & (_lag_distance(lg, li, lag_period)
                             <= exclude_lag))
        alive = alive.scatter(-1, i, False)
        slots.append((torch.where(filled, vi[..., 0], -float("inf")),
                      torch.where(filled, fi[..., 0], 0).to(torch.int32),
                      torch.where(filled, li[..., 0], 0).to(torch.int32),
                      torch.where(filled, order.gather(-1, i)[..., 0],
                                  0).to(torch.int32)))
    out_v, out_f, out_l, orig = (torch.stack(x, dim=-1) for x in zip(*slots))
    out = CafPeak(out_v, out_f, out_l)
    return (out, orig) if return_indices else out


def resolution_cell(needle, freqs_hz, sample_rate) -> Tuple[int, int]:
    """NMS exclusion windows ``(exclude_freq_bins, exclude_lag_samples)``
    sized to the CAF mainlobe: doppler ``fs/N`` Hz in bins of the
    caller's grid, lag ``fs/B`` samples with ``B`` the needle's occupied
    (-20 dB) two-sided bandwidth (host numpy)."""
    x = np.asarray(needle.cpu() if isinstance(needle, torch.Tensor)
                   else needle)
    n = x.shape[-1]
    fs = float(sample_rate)
    freqs = np.asarray(freqs_hz, dtype=np.float64).reshape(-1)
    step = float(np.min(np.abs(np.diff(freqs)))) if freqs.size > 1 \
        else fs / n
    exclude_freq = max(1, int(np.ceil((fs / n) / max(step, 1e-30))))
    psd = np.abs(np.fft.fft(x.astype(np.complex128))) ** 2
    occupied = int(np.count_nonzero(psd > psd.max() * 1e-2))
    bandwidth = max(occupied, 1) * fs / n
    exclude_lag = max(1, int(np.ceil(fs / bandwidth)))
    return exclude_freq, exclude_lag


def resolve_exclusions(needle, freqs_hz, sample_rate,
                       exclude_freq: Optional[int],
                       exclude_lag: Optional[int]) -> Tuple[int, int]:
    """Fill unset NMS exclusion windows from :func:`resolution_cell`."""
    if exclude_freq is None or exclude_lag is None:
        auto_f, auto_l = resolution_cell(needle, freqs_hz, sample_rate)
        exclude_freq = auto_f if exclude_freq is None else exclude_freq
        exclude_lag = auto_l if exclude_lag is None else exclude_lag
    return int(exclude_freq), int(exclude_lag)


def detection_threshold_db(num_cells: int,
                           false_alarm: float = 1e-3) -> float:
    """SNR threshold (dB over the mean surface floor) for a per-search
    false-alarm probability: noise-only mag^2 cells are ~iid exponential,
    so P(any of n cells > T x mean) ~ n e^-T gives T = ln(n / P_fa)."""
    n = max(int(num_cells), 2)
    return 10.0 * float(np.log10(np.log(n / float(false_alarm))))


def apply_detection_threshold(values, floor, num_cells: int, min_snr_db
                              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lattice slots -> detections (host numpy): ``(values_masked,
    snr_db, threshold_db)``.  ``floor`` is the mean mag^2 over the
    searched cells (a scalar, or one per pair broadcast against
    ``values``); slots below the threshold mask to -inf.  ``min_snr_db``:
    a float, ``"auto"`` (:func:`detection_threshold_db` of the cell
    count) or ``None`` (no masking, SNRs still returned)."""
    values = np.asarray(values, np.float64)
    floor = np.maximum(np.asarray(floor, np.float64), 1e-300)
    if floor.ndim and floor.ndim < values.ndim:
        floor = floor.reshape(floor.shape + (1,) * (values.ndim
                                                    - floor.ndim))
    with np.errstate(divide="ignore", invalid="ignore"):
        snr = 10.0 * np.log10(
            np.where(values > 0, values, np.nan) / floor)
    snr = np.where(np.isfinite(values) & (values > 0), snr, -np.inf)
    if min_snr_db is None:
        return values, snr, float("-inf")
    thresh = (detection_threshold_db(num_cells)
              if isinstance(min_snr_db, str) and min_snr_db == "auto"
              else float(min_snr_db))
    keep = snr >= thresh
    return np.where(keep, values, -np.inf), snr, thresh
