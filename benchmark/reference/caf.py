"""The plain cross-ambiguity function, and its peak.

For a needle n (N samples), a haystack h and a bin at f Hz, the CAF at
lag tau is ``sum_t h[tau + t] * conj(n[t] * exp(2j pi f t / fs))``,
with h zero outside its samples; its value is ``|CAF|^2``.  Here, for
each bin: shift the needle, cross-correlate it with the haystack by an
``m``-point FFT with zero-padding (lag tau at index ``tau mod m``), take
``|.|^2`` and keep the 2-D argmax over the lags asked for.  Plain
``torch.fft`` in complex128, in blocks of bins; it imports nothing of
the port and takes nothing the port made.

``precision="bfloat16"`` is the control, the same computation one
precision below the configuration's complex64: every operand that
enters a product or a transform (needle, haystack, phasors, shifted
needle, both spectra, their product) rounded to bfloat16, each
transform and product computed in float32 from the rounded operands.

Two generalisations serve the lattice and rate engines.  ``slots=k``
also gives each pair's greedy exclusion lattice: slot 0 is the 2-D
argmax, slot j the argmax over the cells outside the ``Box`` of each of
slots 0..j-1 (``ops/peak.find_peaks``'s rule, written again here).
``chirps`` (R, N) multiplies the needle by each trial rate's unit chirp
before the frequency shift: a rate axis, its keys (rate index, bin,
lag); what a bin's frequency means at a rate is the chirp the caller
passes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

BLOCK_BYTES = 2 ** 28     # a block of bins' complex128 rows at most


def _bf16(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor's planes rounded to bfloat16 (held in float32)."""
    return torch.complex(z.real.to(torch.bfloat16).float(),
                         z.imag.to(torch.bfloat16).float())


def _rows(n: torch.Tensor, h_spec: torch.Tensor, freqs: torch.Tensor,
          fs: float, m: int, precision: str) -> torch.Tensor:
    """(bins, m) ``|CAF|^2`` rows of one pair, lag tau at ``tau mod m``."""
    t = torch.arange(n.shape[-1], dtype=torch.float64, device=n.device)
    phase = (2.0 * math.pi / fs) * freqs[:, None] * t[None, :]
    if precision == "float64":
        shifted = n[None, :] * torch.polar(torch.ones_like(phase), phase)
        spec = torch.fft.fft(shifted, n=m, dim=-1)
        c = torch.fft.ifft(h_spec[None, :] * spec.conj(), dim=-1)
        return c.real * c.real + c.imag * c.imag
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    phasor = _bf16(torch.polar(torch.ones_like(phase), phase).to(
        torch.complex64))
    shifted = _bf16(n[None, :] * phasor)
    spec = _bf16(torch.fft.fft(shifted, n=m, dim=-1))
    c = torch.fft.ifft(_bf16(h_spec[None, :] * spec.conj()), dim=-1)
    return c.real * c.real + c.imag * c.imag


@dataclass(frozen=True)
class Box:
    """A lattice slot's exclusion box: a key lies in the box of an
    earlier slot's key where its bin is at most ``freq`` bins and its lag
    at most ``lag`` lags away (circularly at ``lag_period``, where the
    entry's lags are circular), at every rate.  A rate cell whose
    engine merges by another rule gives its own ``covers``."""
    freq: int
    lag: int
    lag_period: Optional[int] = None

    def covers(self, at, key):
        """Whether ``key`` lies in the box of ``at``: keys (bin, lag) or
        (rate index, bin, lag), their parts ints or tensors that
        broadcast."""
        (k0, lag0), (k, lag) = at[-2:], key[-2:]
        d = abs(lag - lag0)
        if self.lag_period is not None:
            d = torch.minimum(d, self.lag_period - d) if isinstance(
                d, torch.Tensor) else min(d, self.lag_period - d)
        return (abs(k - k0) <= self.freq) & (d <= self.lag)


def _better(best, sel: torch.Tensor, pre: tuple, k0: int, lag0: int):
    """``best`` (*pre, bin, lag, value), or the argmax of ``sel`` (bins
    from ``k0``, lags from ``lag0``) where that is larger; cells at -inf
    are no candidates."""
    flat = int(torch.argmax(sel))
    k, j = divmod(flat, sel.shape[1])
    v = float(sel[k, j])
    if v == -math.inf or (best is not None and v <= best[-1]):
        return best
    return (*pre, k0 + k, lag0 + j, v)


def peaks(needles: np.ndarray, hays: np.ndarray, freqs: np.ndarray,
          fs: float, m: int, lo: int, hi: int,
          probes: List[Iterable[Tuple[int, ...]]], precision: str = "float64",
          device: str = "cuda",
          spans: Sequence[Tuple[int, int]] = (), slots: int = 1,
          box: Optional[Box] = None,
          chirps: Optional[np.ndarray] = None) -> List[Dict]:
    """Per pair of ``needles`` (P, N) and ``hays`` (P, L): the 2-D
    argmax over every bin and the lags ``[lo, hi)`` as ``best`` (bin,
    lag, value), the value at each (bin, lag) of ``probes[p]`` as
    ``probes``, the 2-D argmax over the lags of each of ``spans``
    (``[a, b)`` inside ``[lo, hi)``) as ``spans``, and the greedy
    exclusion lattice of ``slots`` slots under ``box`` as ``slots``
    (slot 0 is ``best``; a slot with no cell left outside the earlier
    boxes is None).  With ``chirps`` (R, N), each key has the rate's
    index first: (rate index, bin, lag[, value])."""
    if hi - lo > m or hays.shape[-1] > m:
        raise ValueError(f"lags [{lo}, {hi}) or {hays.shape[-1]} samples "
                         f"do not fit an {m}-point correlation")
    if any(not lo <= a < b <= hi for a, b in spans):
        raise ValueError(f"spans {spans} not inside lags [{lo}, {hi})")
    if slots > 1 and box is None:
        raise ValueError(f"{slots} slots need an exclusion box")
    dev = torch.device(device)
    cdt = torch.complex128 if precision == "float64" else torch.complex64
    f = torch.from_numpy(np.asarray(freqs, np.float64)).to(dev)
    cols = torch.remainder(torch.arange(lo, hi, device=dev), m)
    block = max(1, BLOCK_BYTES // (16 * m))
    mods = [None] if chirps is None else torch.from_numpy(
        np.asarray(chirps)).to(dev, cdt)
    out = []
    for p in range(needles.shape[0]):
        n0 = torch.from_numpy(needles[p]).to(dev, cdt)
        h = torch.from_numpy(hays[p]).to(dev, cdt)
        if precision == "bfloat16":
            n0, h = _bf16(n0), _bf16(h)
        h_spec = torch.fft.fft(h, n=m)
        if precision == "bfloat16":
            h_spec = _bf16(h_spec)

        def blocks():
            """(key prefix, first bin, rows, rows at the lags asked for)
            of each block of bins, rate by rate."""
            for r, mod in enumerate(mods):
                pre = () if mod is None else (r,)
                n = n0
                if mod is not None:
                    n = n0 * mod if precision == "float64" else _bf16(
                        n0 * _bf16(mod))
                for k0 in range(0, len(freqs), block):
                    rows = _rows(n, h_spec, f[k0:k0 + block], fs, m,
                                 precision)
                    yield pre, k0, rows, rows[:, cols]

        want = sorted(set(probes[p]))
        best, got = None, {}
        span_best = [None] * len(spans)
        kept = []      # the lattice's later passes reread these blocks
        for pre, k0, rows, sel in blocks():
            best = _better(best, sel, pre, k0, lo)
            for s, (a, b) in enumerate(spans):
                span_best[s] = _better(span_best[s], sel[:, a - lo:b - lo],
                                       pre, k0, a)
            for key in want:
                kk, lag = key[-2:]
                if (tuple(key[:-2]) == pre and k0 <= kk < k0 + rows.shape[0]
                        and lo <= lag < hi):
                    got[key] = float(rows[kk - k0, lag % m])
            if slots > 1:
                kept.append((pre, k0, sel))
        found = [best]
        lags = torch.arange(lo, hi, device=dev)[None, :]
        for _ in range(1, slots):
            nxt = None
            for pre, k0, sel in kept:
                bins = torch.arange(k0, k0 + sel.shape[0], device=dev)[:, None]
                inside = torch.zeros_like(sel, dtype=torch.bool)
                for at in found:
                    if at is not None:
                        inside |= box.covers(at[:-1], (*pre, bins, lags))
                nxt = _better(nxt, sel.masked_fill(inside, -math.inf), pre,
                              k0, lo)
            found.append(nxt)
        out.append({"best": best, "probes": got, "spans": span_best,
                    "slots": found, "box": box})
    return out
