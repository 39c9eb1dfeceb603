"""Peak extraction over the delay x doppler surface.

Tie-breaks match the JAX package: ``torch.argmax`` returns the first
maximum (lowest flat index), as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
    capped at the grid size), computed in the grid's dtype."""
    dtype = freqs_hz.dtype
    k = freqs_hz.shape[-1]
    step = (freqs_hz[min(1, k - 1)] - freqs_hz[0]).abs()
    step = torch.clamp(step, min=1e-30)
    cell = torch.as_tensor(sample_rate, dtype=dtype,
                           device=freqs_hz.device) / needle_len
    return torch.clamp(torch.ceil(cell / step), 1.0,
                       float(k)).to(torch.int32)
