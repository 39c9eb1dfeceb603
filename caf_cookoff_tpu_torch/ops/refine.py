"""Sub-bin (FDOA, TDOA) refinement: zoom re-scoring past the search grid.

Port of ``caf_cookoff_tpu/ops/refine.py``.  A coarse engine answer is
refined to continuous (freq_hz, lag_samples):

* **FDOA zoom.**  At the coarse lag the product ``z[t] = conj(n[t]) *
  h[lag + t]`` of a true copy is a complex exponential at the frequency
  offset; ``|sum_t z[t] e^{-j 2 pi f t/fs}|^2`` is scored on a 33-point
  grid by a small f32 matmul, and the grid re-centres and shrinks
  geometrically (three rounds take a 0.5 Hz step to ~1e-4 Hz).
* **TDOA zoom.**  With that frequency applied, the cross-spectrum of the
  guard-extended window extends the linear correlation to continuous lag
  by trigonometric interpolation; the same zoom runs over the lag.
* **Second-order** (:func:`refine_peak_rate`): a joint (frequency, rate)
  zoom in centred time, then a host f64 polish past the f32 score floor.

The zooms are f32 matmuls on the caller's device (the card by default);
capture windows are cut on the host, so nothing capture-sized crosses to
the device.  Every FFT ``backend`` name runs ``torch.fft``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import next_pow2, resolve_backend
from caf_cookoff_tpu_torch.ops.shift import real_dtype_of
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal

# Guard samples around the coarse lag: the lag zoom searches
# [lag - GUARD, lag + GUARD].
GUARD = 8
_POINTS = 33          # odd: the current centre stays on the zoom grid
_ITERS = 3            # 0.5 Hz coarse step -> ~1e-4 Hz; 1 sample -> ~2e-4


def _zoom_scores(z_re, z_im, centers, span, num: int, t):
    """|sum_t z[t] e^{-j 2 pi g t}|^2 on ``num`` grid points around each
    row's centre, half-width ``span``: ``z`` (B, n), ``centers`` and
    ``span`` (B,), ``t`` (n,) (seconds for the frequency zoom, signed bin
    over M for the lag zoom).  Returns (grid (B, num), scores (B, num))."""
    offs = torch.linspace(-1.0, 1.0, num, dtype=z_re.dtype,
                          device=z_re.device)
    grid = centers[:, None] + offs[None, :] * span[:, None]
    phase = ((2.0 * math.pi) * grid)[..., None] * t           # (B, num, n)
    c, s = torch.cos(phase), torch.sin(phase)
    zr, zi = z_re[..., None], z_im[..., None]
    # e^{-j phase} * (z_re + j z_im), summed over t.
    re = (c @ zr + s @ zi)[..., 0]
    im = (c @ zi - s @ zr)[..., 0]
    return grid, re * re + im * im


def _zoom_argmax(z_re, z_im, center, span0, t, points: int, iters: int):
    """Iterated zoom of every row: argmax of the score, the grid
    shrinking each round; the last grid's vertex is refined by a
    parabolic fit.  Returns (centres (B,), scores at the argmax (B,))."""
    center, span = center, span0
    value = None
    for _ in range(iters):
        grid, scores = _zoom_scores(z_re, z_im, center, span, points, t)
        i = torch.argmax(scores, dim=-1, keepdim=True)
        at = lambda j: torch.gather(scores, 1, j)[:, 0]  # noqa: E731
        im1 = torch.clamp(i - 1, 0, points - 1)
        ip1 = torch.clamp(i + 1, 0, points - 1)
        step = grid[:, 1] - grid[:, 0]
        denom = at(im1) - 2.0 * at(i) + at(ip1)
        inner = (i[:, 0] > 0) & (i[:, 0] < points - 1) & (denom.abs() > 0.0)
        frac = torch.where(
            inner, torch.clamp(0.5 * (at(im1) - at(ip1)) / denom, -0.5, 0.5),
            torch.zeros_like(denom))
        value = at(i)
        center = torch.gather(grid, 1, i)[:, 0] + frac * step
        span = 2.0 * step          # the next grid brackets the vertex
    return center, value


def _extract_window(h: np.ndarray, lag: int, n: int):
    """Host-side (n + 2*GUARD,) window of capture samples [lag - GUARD,
    lag + n + GUARD), zero-filled outside the capture.  Returns
    ``(window, start)``: window sample ``i`` is capture sample ``start +
    i`` (``start`` may be negative)."""
    win_len = n + 2 * GUARD
    start = int(lag) - GUARD
    w = np.zeros(win_len, h.dtype)
    lo = max(start, 0)
    hi = min(start + win_len, int(h.shape[-1]))
    if hi > lo:
        w[lo - start:hi - start] = h[lo:hi]
    return w, start


def _conj_mul(a: torch.Tensor, b: torch.Tensor):
    """(re, im) of ``conj(a) * b`` in split arithmetic."""
    return (a.real * b.real + a.imag * b.imag,
            a.real * b.imag - a.imag * b.real)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """``x * (c + j s)`` in split arithmetic, as a complex tensor."""
    return torch.complex(x.real * c - x.imag * s, x.real * s + x.imag * c)


def _lag_zoom(n, w, phase, points: int, iters: int):
    """The TDOA zoom with ``e^{j phase}`` applied to the needles: the
    cross-spectrum ``W conj(Y)`` of the windows against the shifted
    needles, zoomed over continuous window-local lag around GUARD.
    Returns (tau (B,), value (B,), W, the signed bins k)."""
    rdtype = real_dtype_of(n.dtype)
    m = next_pow2(w.shape[-1] + n.shape[-1])
    y = _rotate(n, torch.cos(phase), torch.sin(phase))
    wf = torch.fft.fft(pad_to(w, m))
    yf = torch.fft.fft(pad_to(y, m))
    c_re = wf.real * yf.real + wf.imag * yf.imag      # W * conj(Y)
    c_im = wf.imag * yf.real - wf.real * yf.imag
    # Signed bins: trig interpolation of the band-limited correlation
    # needs k in [-M/2, M/2).  r(tau) = (1/M) sum_k C[k] e^{+j2pi k tau/M};
    # the zoom scores e^{-j phase}, so it scores conj(C) (|r| unchanged).
    k = torch.arange(m, dtype=rdtype, device=n.device)
    k = torch.where(k < m / 2, k, k - m)
    g = torch.full((n.shape[0],), float(GUARD), dtype=rdtype, device=n.device)
    tau, value = _zoom_argmax(c_re, -c_im, g, g, k / m, points, iters)
    return tau, value * ((1.0 / m) * (1.0 / m)), wf, k


def _time_axis(n, sample_rate):
    rdtype = real_dtype_of(n.dtype)
    return (torch.arange(n.shape[-1], dtype=rdtype, device=n.device)
            / torch.tensor(sample_rate, dtype=rdtype, device=n.device))


def _refine_core(n, w, f0, coarse_step: float, sample_rate, points: int,
                 iters: int):
    """The zoom on pre-extracted windows, every row of a batch: needles
    ``n`` (B, N), windows ``w`` (B, N + 2*GUARD) with the coarse lag at
    window-local GUARD, ``f0`` (B,).  Returns (f (B,), window-local tau
    (B,), |r|^2 (B,))."""
    rdtype = real_dtype_of(n.dtype)
    nl = n.shape[-1]
    z_re, z_im = _conj_mul(n, w[:, GUARD:GUARD + nl])
    t_sec = _time_axis(n, sample_rate)
    step = torch.full_like(f0, coarse_step)
    f_hat, _ = _zoom_argmax(z_re, z_im, f0, step, t_sec, points, iters)
    two_pi_fs = (torch.tensor(2.0 * math.pi, dtype=rdtype, device=n.device)
                 / torch.tensor(sample_rate, dtype=rdtype, device=n.device))
    phase = (two_pi_fs * f_hat)[:, None] * torch.arange(
        nl, dtype=rdtype, device=n.device)
    tau_hat, value, wf, k = _lag_zoom(n, w, phase, points, iters)
    # Second FDOA pass on the fractionally aligned window: a sub-sample
    # delay leaves the first pass's product on a misaligned copy (a
    # ~0.01 Hz bias at half-sample offsets); advancing the window by the
    # fraction of tau (shift theorem on W) removes it, and the zoom
    # re-brackets at 1/16 of the coarse step.
    m = wf.shape[-1]
    lag_int = torch.round(tau_hat)
    ph = ((2.0 * math.pi / m) * k)[None, :] * (tau_hat - lag_int)[:, None]
    wa = torch.fft.ifft(_rotate(wf, torch.cos(ph), torch.sin(ph)))
    li = torch.clamp(lag_int.long(), 0, m - nl)
    a = torch.gather(wa, 1, li[:, None] + torch.arange(nl, device=n.device))
    z2_re, z2_im = _conj_mul(n, a)
    f_hat, _ = _zoom_argmax(z2_re, z2_im, f_hat, step / 16.0, t_sec, points,
                            2)
    return f_hat, tau_hat, value


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_pair(needles: np.ndarray, windows: np.ndarray, device):
    n = as_signal(needles, device)
    return n, as_signal(windows, n.device).to(n.dtype)


def refine_peak(needle, haystack, freq_hz: float, lag: int, sample_rate, *,
                coarse_step_hz: Optional[float] = None,
                backend: Optional[str] = None, points: int = _POINTS,
                iters: int = _ITERS, device=None
                ) -> Tuple[float, float, float]:
    """Refine a coarse peak to continuous ``(freq_hz, lag_samples,
    value)``.  ``lag`` is a signed absolute capture offset (unwrap
    circular xcor indices with ``ops.peak.unwrap_lag`` first);
    ``coarse_step_hz`` is the grid step of the answer (the zoom's first
    bracket, default 0.5 Hz); ``value`` is the exact ``|r|^2`` at the
    refined point."""
    resolve_backend(backend)
    nd, hs = _host(needle), _host(haystack)
    w, start = _extract_window(hs, int(lag), nd.shape[-1])
    n, w = _device_pair(nd[None], w[None], device)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    f0 = torch.tensor([float(freq_hz)], dtype=real_dtype_of(n.dtype),
                      device=n.device)
    f_hat, tau_hat, value = _refine_core(n, w, f0, step, float(sample_rate),
                                         int(points), int(iters))
    return float(f_hat[0]), start + float(tau_hat[0]), float(value[0])


def refine_peaks(needles, haystacks, freqs_hz, lags, sample_rate, *,
                 coarse_step_hz: Optional[float] = None,
                 backend: Optional[str] = None, points: int = _POINTS,
                 iters: int = _ITERS, device=None):
    """Batched :func:`refine_peak`: ``(B, N)`` needles, ``(B, L)``
    captures and ``(B,)`` coarse answers -> ``(freqs (B,), lags (B,),
    values (B,))`` numpy arrays (lags fractional).  One zoom over the
    batch; windows are cut per pair on the host."""
    resolve_backend(backend)
    nds, hss = _host(needles), _host(haystacks)
    cut = [_extract_window(hss[i], int(lag), nds.shape[-1])
           for i, lag in enumerate(np.asarray(lags).astype(np.int64))]
    n, w = _device_pair(nds, np.stack([c[0] for c in cut]), device)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    f0 = torch.as_tensor(np.asarray(freqs_hz), dtype=real_dtype_of(n.dtype),
                         device=n.device).reshape(-1)
    f_hat, tau_hat, value = _refine_core(n, w, f0, step, float(sample_rate),
                                         int(points), int(iters))
    starts = np.asarray([c[1] for c in cut], np.float64)
    return (f_hat.cpu().numpy(),
            starts + tau_hat.cpu().numpy().astype(np.float64),
            value.cpu().numpy())


def _joint_freq_rate_scores(z_re, z_im, t_sec, f_grid, r_grid):
    """|sum_t z[t] e^{-j 2 pi f t} e^{-j pi r t^2}|^2 on the outer product
    of the two grids, (pf, pr), by split matmuls."""
    ph_r = (math.pi * r_grid)[None, :] * (t_sec * t_sec)[:, None]  # (n, pr)
    cr, sr = torch.cos(ph_r), torch.sin(ph_r)
    zr_re = z_re[:, None] * cr + z_im[:, None] * sr
    zr_im = z_im[:, None] * cr - z_re[:, None] * sr
    ph_f = ((2.0 * math.pi) * f_grid)[:, None] * t_sec[None, :]    # (pf, n)
    cf, sf = torch.cos(ph_f), torch.sin(ph_f)
    re = cf @ zr_re + sf @ zr_im
    im = cf @ zr_im - sf @ zr_re
    return re * re + im * im


def _zoom_freq_rate(z_re, z_im, t_sec, f0, f_span, r0, r_span, points: int,
                    iters: int):
    """Joint 2-D geometric zoom over (frequency, rate); the first
    maximum of each round's grid wins."""
    offs = torch.linspace(-1.0, 1.0, points, dtype=z_re.dtype,
                          device=z_re.device)
    f_c, r_c, value = f0, r0, None
    for _ in range(iters):
        f_grid = f_c + offs * f_span
        r_grid = r_c + offs * r_span
        scores = _joint_freq_rate_scores(z_re, z_im, t_sec, f_grid,
                                         r_grid).reshape(-1)
        flat = torch.argmax(scores)
        value = scores[flat]
        f_c, r_c = f_grid[flat // points], r_grid[flat % points]
        f_span = 2.0 * (f_grid[1] - f_grid[0])
        r_span = 2.0 * (r_grid[1] - r_grid[0])
    return f_c, r_c, value


def _refine_rate_core(n, w, f0: float, r0: float, coarse_step: float,
                      max_rate: float, sample_rate, points: int, iters: int):
    """The second-order zoom of one pair (``n`` (1, N), ``w`` (1,
    N + 2*GUARD)): (f at the window start, rate, window-local tau,
    |r|^2), device scalars."""
    rdtype = real_dtype_of(n.dtype)
    dev = n.device
    scalar = lambda x: torch.tensor(x, dtype=rdtype, device=dev)  # noqa: E731
    nl = n.shape[-1]
    z_re, z_im = (x[0] for x in _conj_mul(n, w[:, GUARD:GUARD + nl]))
    t_sec = _time_axis(n, sample_rate)
    # Centred time decorrelates (f, r): over [0, T] a rate error
    # masquerades as a frequency shift of r*T/2, a diagonal ridge an
    # axis-aligned zoom stalls on.  The zoom then estimates the mid-window
    # frequency, converted back to the window-start convention.
    half_t = t_sec[-1] * 0.5
    f_mid, r_hat, _ = _zoom_freq_rate(
        z_re, z_im, t_sec - half_t, scalar(f0) + scalar(r0) * half_t,
        scalar(coarse_step), scalar(r0), scalar(max_rate), points, iters)
    f_hat = f_mid - r_hat * half_t
    # The lag zoom with the full second-order model applied to the needle.
    phase = ((2.0 * math.pi) * f_hat * t_sec
             + math.pi * r_hat * t_sec * t_sec)[None, :]
    tau_hat, value, _, _ = _lag_zoom(n, w, phase, points, iters)
    return f_hat, r_hat, tau_hat[0], value[0]


def _polish_freq_rate_f64(n_c, g_c, sample_rate, f_start, r_hat,
                          f_span, r_span, points=_POINTS, iters=6,
                          r_bounds=None):
    """Host f64 joint (f, r) zoom — the precision stage past the
    on-device f32 score floor (host numpy, as in the JAX package).

    Near the (f, r) vertex the score surface is flat to ~(pi dr
    sigma_{t^2})^2/2 relative, below the f32 summation noise of a
    4k-term coherent sum, so the device zoom saturates ~2 Hz/s off; a few
    f64 iterations on the already-extracted window land ~1e-3 Hz/s.
    ``f_start`` is the window-start frequency; returns the same
    convention.  ``r_bounds`` (lo, hi) caps every rate candidate (the
    caller's ``rate0 +- max_rate`` bracket)."""
    n = n_c.shape[-1]
    t = np.arange(n, dtype=np.float64) / float(sample_rate)
    half_t = t[-1] * 0.5
    t_c = t - half_t
    z = np.conj(n_c).astype(np.complex128) * g_c.astype(np.complex128)
    f_c = float(f_start) + float(r_hat) * half_t   # mid-window
    r_c = float(r_hat)
    offs = np.linspace(-1.0, 1.0, points)
    t2 = t_c * t_c
    for _ in range(iters):
        f_grid = f_c + offs * f_span
        r_grid = r_c + offs * r_span
        if r_bounds is not None:
            # Clip only the scored candidates; the next span derives from
            # the unclipped spacing, or a bracket narrower than the span
            # floor would collapse the span to ~0 in one iteration.
            r_grid = np.clip(r_grid, r_bounds[0], r_bounds[1])
        zr = z[:, None] * np.exp(-1j * np.pi * r_grid[None, :] * t2[:, None])
        e = np.exp(-2j * np.pi * f_grid[:, None] * t_c[None, :])
        scores = np.abs(e @ zr) ** 2                   # (pf, pr)
        fi, ri = np.unravel_index(int(scores.argmax()), scores.shape)
        f_c = float(f_grid[fi])
        r_c = float(r_grid[ri])
        f_span = 2.0 * (f_grid[1] - f_grid[0])
        r_span = 2.0 * r_span * (offs[1] - offs[0])    # unclipped step
    return f_c - r_c * half_t, r_c


def refine_peak_rate(needle, haystack, freq_hz: float, lag: int,
                     sample_rate, *, rate0_hz_per_s: float = 0.0,
                     max_rate_hz_per_s: Optional[float] = None,
                     coarse_step_hz: Optional[float] = None,
                     backend: Optional[str] = None, points: int = _POINTS,
                     iters: int = 4, device=None):
    """Second-order refinement: continuous ``(freq_hz, rate_hz_per_s,
    lag_samples, value)`` of a linearly swept emitter.

    The product at the coarse lag is ``e^{j 2 pi f t + j pi r t^2}``; a
    joint (f, r) zoom (dechirp columns x frequency rows) recovers both,
    a host f64 polish takes them past the f32 floor, then the lag zoom
    runs with the full model applied to the needle.  ``rate0_hz_per_s``
    centres the rate bracket (pass a rate engine's answer);
    ``max_rate_hz_per_s`` is its half-width, by default one coarse
    frequency step of drift over the needle.  Frequencies use the
    window-start convention."""
    resolve_backend(backend)
    nd, hs = _host(needle), _host(haystack)
    nl = nd.shape[-1]
    w, start = _extract_window(hs, int(lag), nl)
    n, w_t = _device_pair(nd[None], w[None], device)
    step = 0.5 if coarse_step_hz is None else float(coarse_step_hz)
    if max_rate_hz_per_s is None:
        max_rate_hz_per_s = step / (nl / float(sample_rate))
    f_hat, r_hat, tau_hat, value = _refine_rate_core(
        n, w_t, float(freq_hz), float(rate0_hz_per_s), step,
        float(max_rate_hz_per_s), float(sample_rate), int(points),
        int(iters))
    # The 4 Hz/s floor of the polish's bracket out-brackets the device
    # zoom's ~2 Hz/s f32 saturation; the candidates stay clipped to the
    # caller's rate0 +- max_rate.
    r_lo = float(rate0_hz_per_s) - float(max_rate_hz_per_s)
    r_hi = float(rate0_hz_per_s) + float(max_rate_hz_per_s)
    f_pol, r_pol = _polish_freq_rate_f64(
        nd.astype(np.complex128), w[GUARD:GUARD + nl].astype(np.complex128),
        sample_rate, float(f_hat), float(r_hat),
        f_span=max(step / 8.0, 0.05),
        r_span=max(float(max_rate_hz_per_s) / 16.0, 4.0),
        r_bounds=(r_lo, r_hi))
    return (f_pol, r_pol, start + float(tau_hat), float(value))
