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
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

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


def _better(best, sel: torch.Tensor, k0: int, lag0: int):
    """``best`` (bin, lag, value), or the argmax of ``sel`` (bins from
    ``k0``, lags from ``lag0``) where that is larger."""
    flat = int(torch.argmax(sel))
    k, j = divmod(flat, sel.shape[1])
    v = float(sel[k, j])
    return best if best is not None and v <= best[2] else (k0 + k,
                                                           lag0 + j, v)


def peaks(needles: np.ndarray, hays: np.ndarray, freqs: np.ndarray,
          fs: float, m: int, lo: int, hi: int,
          probes: List[Iterable[Tuple[int, int]]], precision: str = "float64",
          device: str = "cuda",
          spans: Sequence[Tuple[int, int]] = ()) -> List[Dict]:
    """Per pair of ``needles`` (P, N) and ``hays`` (P, L): the 2-D
    argmax over every bin and the lags ``[lo, hi)`` as ``best`` (bin,
    lag, value), the value at each (bin, lag) of ``probes[p]`` as
    ``probes``, and the 2-D argmax over the lags of each of ``spans``
    (``[a, b)`` inside ``[lo, hi)``) as ``spans``."""
    if hi - lo > m or hays.shape[-1] > m:
        raise ValueError(f"lags [{lo}, {hi}) or {hays.shape[-1]} samples "
                         f"do not fit an {m}-point correlation")
    if any(not lo <= a < b <= hi for a, b in spans):
        raise ValueError(f"spans {spans} not inside lags [{lo}, {hi})")
    dev = torch.device(device)
    cdt = torch.complex128 if precision == "float64" else torch.complex64
    f = torch.from_numpy(np.asarray(freqs, np.float64)).to(dev)
    cols = torch.remainder(torch.arange(lo, hi, device=dev), m)
    block = max(1, BLOCK_BYTES // (16 * m))
    out = []
    for p in range(needles.shape[0]):
        n = torch.from_numpy(needles[p]).to(dev, cdt)
        h = torch.from_numpy(hays[p]).to(dev, cdt)
        if precision == "bfloat16":
            n, h = _bf16(n), _bf16(h)
        h_spec = torch.fft.fft(h, n=m)
        if precision == "bfloat16":
            h_spec = _bf16(h_spec)
        want = sorted(set(probes[p]))
        best, got = None, {}
        span_best = [None] * len(spans)
        for k0 in range(0, len(freqs), block):
            rows = _rows(n, h_spec, f[k0:k0 + block], fs, m, precision)
            sel = rows[:, cols]
            best = _better(best, sel, k0, lo)
            for s, (a, b) in enumerate(spans):
                span_best[s] = _better(span_best[s], sel[:, a - lo:b - lo],
                                       k0, a)
            for kk, lag in want:
                if k0 <= kk < k0 + rows.shape[0] and lo <= lag < hi:
                    got[(kk, lag)] = float(rows[kk - k0, lag % m])
        out.append({"best": best, "probes": got, "spans": span_best})
    return out
