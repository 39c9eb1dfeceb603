"""What every Stein engine does around its core: the route and the call.

* The route: the block length D (:func:`_auto_block_len`,
  :func:`_pow2_block_len`), and for grids past one band's envelope the
  band plan (:func:`_plan_bands`, :func:`_band_routing`).  The windowed
  engines pick plain or banded by cost in :func:`_windowed_route`, which
  raises the ``SpanError`` that leaves neither route open; each engine
  turns it into its own typed error.
* The call: :func:`_compiled_call` runs an engine's checks and route
  (its plan function), its core as one CUDA graph per static key
  (``ops/_graph``), and reads the packed answer back in one copy
  (:func:`_pack`, :func:`_host`).

The engines (``models/stein``, ``batched_stein``, ``streaming``,
``rate``) import this module; it imports none of them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import floor_pow2, resolve_backend
from caf_cookoff_tpu_torch.errors import SpanError
from caf_cookoff_tpu_torch.ops import _graph
from caf_cookoff_tpu_torch.ops.fused_stein import SUPER
from caf_cookoff_tpu_torch.ops.peak import CafPeak
from caf_cookoff_tpu_torch.ops.shift import numpy_real
from caf_cookoff_tpu_torch.utils.convert import as_signal
from caf_cookoff_tpu_torch.utils.profiling import recording, span


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


def _pow2_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Largest power-of-two block length within the sinc-envelope limit
    (:func:`_auto_block_len`), capped at ``SUPER`` so SUPER-padded
    needles split into whole blocks."""
    d = floor_pow2(min(_auto_block_len(sample_rate, freqs_hz, requested),
                       SUPER))
    if d < 8:
        raise SpanError("block length below 8 after pow2 rounding")
    return d


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


def _windowed_route(sample_rate, freqs_np, plain_block_len: Callable[[], int],
                    *, margin_hz: float = 0.0, d_cap: Optional[int] = None):
    """The windowed engines' route: ``plain_block_len()`` is the plain
    route's block length or raises ``SpanError``; :func:`_band_routing`
    then picks plain or banded.  Returns ``(use_banded, d, freqs_pad,
    centers, rel)``; raises the plain route's ``SpanError`` when the grid
    does not band either."""
    try:
        d, span_err = plain_block_len(), None
    except SpanError as e:
        d, span_err = None, e
    route = _band_routing(sample_rate, freqs_np, d, margin_hz=margin_hz,
                          d_cap=d_cap)
    if route[1] is None:
        raise span_err
    return route


def _equal_batch(needles, haystacks, device):
    """An equal-length (P, N) batch on the device."""
    ns = as_signal(needles, device)
    hs = as_signal(haystacks, ns.device).to(ns.dtype)
    if ns.ndim != 2 or hs.shape != ns.shape:
        raise ValueError(
            f"need matching (P, N) batches, got {tuple(ns.shape)} vs "
            f"{tuple(hs.shape)}")
    return ns, hs


def _long_batch(needles, haystacks, device):
    """(P, N) needles and (P, L) haystacks on the device."""
    ns = as_signal(needles, device)
    hs = as_signal(haystacks, ns.device).to(ns.dtype)
    if ns.ndim != 2 or hs.ndim != 2 or ns.shape[0] != hs.shape[0]:
        raise ValueError(
            f"need (P, N) needles and (P, L) haystacks, got "
            f"{tuple(ns.shape)} vs {tuple(hs.shape)}")
    return ns, hs


def _pack(peak: CafPeak) -> torch.Tensor:
    """A peak's (value, freq_idx, lag_idx) stacked as one (3, ...) f64
    tensor (exact for f32/f64 values and int32 indices), so the host
    reads it in one copy."""
    return torch.stack([peak.value.double(), peak.freq_idx.double(),
                        peak.lag_idx.double()])


def _host(freqs: np.ndarray, peak, value_dtype=None):
    """(freqs, lags, values) numpy arrays of a batch's peaks (``(P,)``,
    or ``(P, k)`` lattices) from a :class:`CafPeak`, or from its
    :func:`_pack`ed form with the values' ``value_dtype``: one copy to
    the host."""
    with span("caf.read"):
        if isinstance(peak, CafPeak):
            peak, value_dtype = _pack(peak), peak.value.dtype
        value, freq_idx, lag = peak.cpu().numpy()
        return (freqs[freq_idx.astype(np.int64)], lag.astype(np.int32),
                value.astype(numpy_real(value_dtype)))


def _compiled_call(backend, plan, *args):
    """A public call: ``plan(*args)``'s checks and routing (``(core,
    traced, static, host grid, value dtype)``), its compiled call and the
    packed read, with the spans ``caf.call`` and ``caf.prep`` while a
    profiler runs."""
    if not recording():
        resolve_backend(backend)
        core, traced, static, freqs, vdt = plan(*args)
        return _host(freqs, _graph.compiled(core, traced, static), vdt)
    with span("caf.call"):
        with span("caf.prep"):
            resolve_backend(backend)
            core, traced, static, freqs, vdt = plan(*args)
        return _host(freqs, _graph.compiled(core, traced, static), vdt)


def _as_tensor(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, copied without waiting for the
    card."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device, non_blocking=True)


def _band_tensors(plan, device):
    """A band plan's ``freqs_pad``, ``centers`` and ``rel`` on
    ``device``."""
    return tuple(_as_tensor(plan[k], device)
                 for k in ("freqs_pad", "centers", "rel"))


def _grid_on(freqs_hz, freqs: np.ndarray, device) -> torch.Tensor:
    """The grid on ``device``: the caller's tensor when it is there
    already (in the host grid ``freqs``'s dtype), else ``freqs``
    copied."""
    if isinstance(freqs_hz, torch.Tensor) and freqs_hz.device == device:
        return freqs_hz.detach().to(torch.from_numpy(freqs[:0]).dtype)
    return _as_tensor(freqs, device)
