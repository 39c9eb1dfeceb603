"""Randomized cross-package consistency (seeded, deterministic).

The workloads of tests/test_consistency_fuzz.py — random needle lengths,
on-grid dopplers, lags incl. edges — through the port's exact engines
(filterbank and Stein, fused, unfused and banded) and the JAX package's
Stein engine: identical (freq, lag), and the planted emitter.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models.stein import stein_caf_peak as jax_stein_peak
from caf_cookoff_tpu_torch.errors import SpanError
from caf_cookoff_tpu_torch.models.filterbank import caf_peak
from caf_cookoff_tpu_torch.models.stein import stein_caf_peak

torch.set_num_threads(1)

FS = 48_000.0

CASES = [
    # (seed, n, lag, f_idx, grid_start, grid_step, grid_bins)
    (0, 1024, 0, 3, -400.0, 50.0, 16),          # zero lag
    (1, 2048, 1792, 11, -100.0, 12.5, 16),      # late lag, 12% overlap
    (2, 1000, 421, 7, -750.0, 125.0, 12),       # non-pow2 needle
    (3, 4096, 96, 0, -100.0, 25.0, 8),          # grid edge bin
    (4, 512, 300, 15, -1000.0, 125.0, 16),      # last grid bin
    (5, 8192, 5000, 5, -50.0, 6.25, 16),        # long needle, fine grid
]

BANDED_CASES = [
    (6, 2048, 777, 9, -8000.0, 1000.0, 16),     # wide span (banded)
    (7, 4096, 1234, 21, -5000.0, 250.0, 40),    # wide span, denser
]


def _workload(seed, n, lag, f_idx, g0, gs, gk):
    rng = np.random.default_rng(seed)
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    f_true = float(freqs[f_idx])
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(n)
                   + 1j * rng.standard_normal(n))).astype(np.complex64)
    hay[lag:] += (needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS)).astype(np.complex64)[
            :n - lag]
    return needle, hay, freqs, (f_true, lag)


@pytest.mark.parametrize("seed,n,lag,f_idx,g0,gs,gk", CASES)
def test_port_engines_agree_with_jax_randomized(seed, n, lag, f_idx, g0, gs,
                                                gk):
    needle, hay, freqs, want = _workload(seed, n, lag, f_idx, g0, gs, gk)
    for backend in ("xla", "matmul-highest"):
        got = caf_peak(needle, hay, freqs, FS, backend=backend,
                       device="cpu")
        assert got[:2] == want, (backend, got)
    for fused in (None, False):
        got = stein_caf_peak(needle, hay, freqs, FS, fused=fused,
                             device="cpu")
        assert got[:2] == want, ("stein", fused, got)
    assert jax_stein_peak(needle, hay, freqs, FS)[:2] == want


@pytest.mark.parametrize("seed,n,lag,f_idx,g0,gs,gk", BANDED_CASES)
def test_wide_spans_raise_until_banded_stein_lands(seed, n, lag, f_idx, g0,
                                                   gs, gk):
    """The banded Stein path has landed: where the JAX package bands the
    span, the port bands it too and answers the planted emitter as JAX
    does (values within rtol 1e-4); pinning the single-band engine
    (``fused=False``) still raises SpanError, and the filterbank still
    answers exactly."""
    needle, hay, freqs, want = _workload(seed, n, lag, f_idx, g0, gs, gk)
    got = stein_caf_peak(needle, hay, freqs, FS, device="cpu")
    jax_got = jax_stein_peak(needle, hay, freqs, FS)
    assert got[:2] == jax_got[:2] == want
    assert got[2] == pytest.approx(jax_got[2], rel=1e-4)
    with pytest.raises(SpanError):
        stein_caf_peak(needle, hay, freqs, FS, fused=False, device="cpu")
    assert caf_peak(needle, hay, freqs, FS, backend="xla",
                    device="cpu")[:2] == want
