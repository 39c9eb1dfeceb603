"""The least device time of a search: the chip's peaks and the work the
Stein rank of a cell's grid needs, frozen as functions of the cell's
sizes.

Frozen copies, so that a change to the port cannot move them:

* the peaks: ``chip_smoke.py:205-207`` (an H100 SXM at 700 W, NVIDIA's
  data sheet: dense bf16 on the tensor cores, f32 outside them, HBM3);
* the operation count: ``chip_smoke.py:1192-1219`` (``stein_bound_ms``):
  per lag each program needs stage A's G column, 2*(2B)*(2D) FLOP, and
  stage B's two syntheses, 2*2*K*2B FLOP, over the lags it ranks;
* the decimation rule that sets B and D: ``models/stein.py:203-245``
  (``_plan_bands``) and ``:283-299`` (``_auto_block_len``),
  ``models/batched_stein.py:60-71`` (``_pow2_block_len``) and
  ``ops/fused_stein.py:54`` (``SUPER``).

The count is taken at the cheaper of the rule's two routes for the
grid, one band or the band plan, whichever route the program takes, so
that it bounds every Stein search of the grid from below.  The bytes
are the search's inputs read once and its answers written once.  The
count does not change with the kernels that carry the search out.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
SUPER = 128           # needle padding quantum of the Stein operands
BLOCK_LEN = 64        # the engines' requested block length
ANSWER_BYTES = 12     # (freq f32, lag int32, value f32) a pair


def floor_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1) if n > 0 else 0


def plain_block_len(fs: float, freqs: np.ndarray,
                    requested: int = BLOCK_LEN) -> Optional[int]:
    """One band's block length D: the block-constant phase error stays
    under ~pi/8 while ``D <= fs / (4 f_max)``, rounded down to a power
    of two, at most ``SUPER``; None below 8."""
    f_max = float(np.max(np.abs(freqs)))
    d = requested if f_max <= 0 else min(requested,
                                         max(int(fs / (4.0 * f_max)), 1))
    d = floor_pow2(min(d, SUPER))
    return d if d >= 8 else None


def band_plan(fs: float, freqs: np.ndarray) -> Optional[Dict]:
    """The band plan of a uniform grid: (D, bins a band, bands) at the
    cheapest ``bands * (1 + kb / D)``, or None."""
    k = len(freqs)
    if k < 2:
        return None
    diffs = np.diff(np.asarray(freqs, np.float64))
    g = float(diffs[0])
    if g <= 0 or not np.allclose(diffs, g, rtol=1e-5, atol=1e-9):
        return None
    best = None
    for d in (8, 16, 32, 64, 128):
        kb = max(1, int(2.0 * (fs / (4.0 * d)) / g))
        s = -(-k // kb)
        cost = s * (1.0 + kb / d)
        if best is None or cost < best[0]:
            best = (cost, d, kb, s)
    return {"block_len": best[1], "kb": best[2], "bands": best[3]}


def _padded(n: int) -> int:
    return n + (-n) % SUPER


def flops_per_lag(needle_len: int, bins: int, block_len: int,
                  bands: int = 1) -> float:
    """Stage A and stage B of every program (one a band) for one lag:
    2B = 2 * N_pad / D rows, 2D columns, K bins a band."""
    b2 = 2 * (_padded(needle_len) // block_len)
    return bands * (2.0 * b2 * (2 * block_len) + 2.0 * 2 * bins * b2)


def routes(needle_len: int, freqs: np.ndarray, fs: float) -> Dict:
    """FLOP a lag on each route the rule offers for the grid."""
    out = {}
    d = plain_block_len(fs, freqs)
    if d is not None:
        out["one_band"] = flops_per_lag(needle_len, len(freqs), d)
    plan = band_plan(fs, freqs)
    if plan is not None:
        out["bands"] = flops_per_lag(needle_len, plan["kb"],
                                     plan["block_len"], plan["bands"])
    return out


def search_bound(needle_len: int, haystack_len: int, freqs: np.ndarray,
                 fs: float, lags: int, pairs: int) -> Dict:
    """A search's least device time: ``pairs`` pairs, each ranked over
    ``lags`` lags on the cheaper route, its inputs read once and its
    answers written once."""
    per_lag = min(routes(needle_len, freqs, fs).values())
    flops = pairs * lags * per_lag
    nbytes = (pairs * 8.0 * (needle_len + haystack_len) + 4.0 * len(freqs)
              + pairs * ANSWER_BYTES)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return {"least_s": max(t_ops, t_bytes), "flops": flops,
            "bytes": nbytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
