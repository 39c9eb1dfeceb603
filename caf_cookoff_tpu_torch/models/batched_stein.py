"""Operands of the fused Stein kernel (the batched engine's
helpers; the batched engine itself is not ported yet).

Stage A of the kernel computes the segment correlations
``G[b, tau] = sum_d conj(n[bD+d]) * h[bD+d+tau]`` as a dense
(2B, 2D) x (2D, span) product of a needle-tap operator and Hankel rows
of a circularly extended haystack; these build the two operands in the
JAX package's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import floor_pow2
from caf_cookoff_tpu_torch.errors import SpanError
from caf_cookoff_tpu_torch.ops.fused_stein import SUPER


def _pow2_block_len(sample_rate: float, freqs_hz: np.ndarray,
                    requested: int) -> int:
    """Largest power-of-two block length within the sinc-envelope limit
    (:func:`caf_cookoff_tpu_torch.models.stein._auto_block_len`), capped
    at ``SUPER`` so SUPER-padded needles split into whole blocks."""
    from caf_cookoff_tpu_torch.models.stein import _auto_block_len

    d = floor_pow2(min(_auto_block_len(sample_rate, freqs_hz, requested),
                       SUPER))
    if d < 8:
        raise SpanError("block length below 8 after pow2 rounding")
    return d


def _needle_operator(ns_re: torch.Tensor, ns_im: torch.Tensor, d: int):
    """(P, 2B, 2*D) dense needle-tap operator for stage A.

    Rows [0, B) produce Re(G), rows [B, 2B) Im(G); columns [0, D) act on
    the haystack's real plane, [D, 2*D) on its imaginary plane.  Needles
    must already be padded to whole blocks.  Returns ``(lmat, D)``.
    """
    p, n_pad = ns_re.shape
    b = n_pad // d
    tr = ns_re.reshape(p, b, d)              # Re(conj n) = nr
    ti = (-ns_im).reshape(p, b, d)           # Im(conj n) = -ni
    # G = sum conj(n)*h: Gr = tr.hr + (-ti).hi;  Gi = ti.hr + tr.hi.
    top = torch.cat([tr, -ti], dim=2)
    bot = torch.cat([ti, tr], dim=2)
    return torch.cat([top, bot], dim=1), d


def _haystack_extension(hs_re: torch.Tensor, hs_im: torch.Tensor, m: int,
                        span: int) -> torch.Tensor:
    """(P, 2, span+SUPER-1) circularly extended haystack planes: the
    M-point correlation indexes h mod M (zeros in [N, M)), so the
    extension tiles the zero-padded period."""
    p, n_h = hs_re.shape
    need = span + SUPER - 1
    reps = -(-need // m)

    def circ(hp):
        base = torch.cat([hp, hp.new_zeros(p, m - n_h)], dim=-1)
        return base.repeat(1, reps)[:, :need]

    return torch.stack([circ(hs_re), circ(hs_im)], dim=1)
