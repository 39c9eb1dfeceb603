"""Batched pair engine — many (needle, haystack) pairs at once.

A (B, N) batch runs with the doppler bank shared across pairs.  The
peak path walks the batch in chunks of a few pairs, so memory stays at
a few (K, M) surfaces whatever B is (a flat batch of B pairs would hold
B of them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import (resolve_backend, signal_grid,
                                          xcor_length)
from caf_cookoff_tpu_torch.ops.peak import find_peak_2d
from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2
from caf_cookoff_tpu_torch.utils.convert import as_signal

_CHUNK = 4      # pairs per surface batch of the peak path


def _split_batch(needles, haystacks, freqs_hz, device):
    ns = as_signal(needles, device)
    hs = as_signal(haystacks, ns.device).to(ns.dtype)
    if ns.ndim != 2 or hs.shape != ns.shape:
        raise ValueError(
            f"need matching (B, N) batches, got {tuple(ns.shape)} vs "
            f"{tuple(hs.shape)}")
    freqs = signal_grid(freqs_hz, ns)
    return ns, hs, freqs, torch.from_numpy(freqs).to(ns.device)


def batched_caf_surface(needles, haystacks, freqs_hz, sample_rate, *,
                        backend: Optional[str] = None,
                        device=None) -> torch.Tensor:
    """(B, K, M) mag^2 surfaces for a (B, N) batch of pairs."""
    resolve_backend(backend)
    ns, hs, _, freqs_t = _split_batch(needles, haystacks, freqs_hz, device)
    return mag2(_surface_rows(ns, hs, freqs_t, float(sample_rate),
                              xcor_length(ns.shape[-1])))


def batched_caf_peak(needles, haystacks, freqs_hz, sample_rate, *,
                     backend: Optional[str] = None, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pair peaks: (freqs_hz (B,), lag_idx (B,), value (B,)).

    Pairs run ``_CHUNK`` at a time (1 when that does not divide B, as in
    the JAX package)."""
    resolve_backend(backend)
    ns, hs, freqs, freqs_t = _split_batch(needles, haystacks, freqs_hz,
                                          device)
    b = ns.shape[0]
    chunk = min(_CHUNK, b)
    if b % chunk:
        chunk = 1
    m = xcor_length(ns.shape[-1])
    peaks = [find_peak_2d(mag2(_surface_rows(
        ns[i:i + chunk], hs[i:i + chunk], freqs_t, float(sample_rate), m)))
        for i in range(0, b, chunk)]
    vals, fidx, lags = (torch.cat(x).cpu().numpy() for x in zip(*peaks))
    return freqs[fidx], lags, vals
