"""The port's overlap-save engine (long captures, block loop) against the
JAX package and a direct linear-correlation oracle, on the CPU.

Mirrors ``tests/test_overlap_save.py``: (freq, lag) answers identical to
the JAX package's, values and surfaces within rtol 1e-4 (f32 FFTs
rounded in another order) or the oracle's bound.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models import overlap_save as jos
from caf_cookoff_tpu_torch.config import FreqGrid
from caf_cookoff_tpu_torch.models import overlap_save as tos
from caf_cookoff_tpu_torch.utils.io import load_c64

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0


def _linear_xcor_oracle(needle, haystack, freqs, fs):
    """Direct O(K * L * N) linear correlation surface, mag^2."""
    n, l = len(needle), len(haystack)
    t = np.arange(n)
    out = np.zeros((len(freqs), l - n + 1))
    for k, f in enumerate(freqs):
        shifted = needle * np.exp(2j * np.pi * float(f) * t / fs)
        for tau in range(l - n + 1):
            out[k, tau] = abs(np.vdot(shifted, haystack[tau:tau + n])) ** 2
    return out


def _cplx(rng, n):
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("n,lags", [(4096, 5000), (100, 1), (1000, 3000)])
def test_plan_blocks_matches_jax(n, lags):
    assert tos.plan_blocks(n, lags) == jos.plan_blocks(n, lags)


def test_surface_matches_oracle_and_jax():
    rng = np.random.default_rng(7)
    needle, haystack = _cplx(rng, 32), _cplx(rng, 300)
    freqs = np.array([-900.0, 0.0, 450.0], dtype=np.float32)
    got = tos.overlap_save_surface(needle, haystack, freqs, FS,
                                   device="cpu").numpy()
    want = _linear_xcor_oracle(needle, haystack, freqs, FS)
    assert got.shape == want.shape == (3, 300 - 32 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    jax_surf = np.asarray(jos.overlap_save_surface(needle, haystack, freqs,
                                                   FS))
    np.testing.assert_allclose(got, jax_surf, rtol=1e-4, atol=1e-4)


def test_surface_block_boundaries_exact():
    """A delta needle makes the correlation a shifted copy: any halo
    off-by-one breaks equality at specific lags."""
    n, l = 16, 200
    needle = np.zeros(n, dtype=np.complex64)
    needle[0] = 1.0
    haystack = _cplx(np.random.default_rng(3), l)
    surf = tos.overlap_save_surface(needle, haystack, np.zeros(1, np.float32),
                                    FS, device="cpu").numpy()
    np.testing.assert_allclose(surf[0], np.abs(haystack[:l - n + 1]) ** 2,
                               rtol=1e-4, atol=1e-5)


def test_peak_matches_surface_argmax_and_jax():
    rng = np.random.default_rng(11)
    n, l, lag = 64, 1000, 517
    needle = _cplx(rng, n)
    haystack = np.zeros(l, dtype=np.complex64)
    haystack[lag:lag + n] = needle * np.exp(
        2j * np.pi * 200.0 * np.arange(n) / FS)
    freqs = np.arange(-400, 400, 50, dtype=np.float32)
    surf = tos.overlap_save_surface(needle, haystack, freqs, FS,
                                    device="cpu").numpy()
    k, t = np.unravel_index(surf.argmax(), surf.shape)
    got = tos.overlap_save_peak(needle, haystack, freqs, FS, device="cpu")
    want = jos.overlap_save_peak(needle, haystack, freqs, FS)
    assert got[:2] == want[:2] == (float(freqs[k]), int(t)) == (200.0, lag)
    assert got[2] == pytest.approx(surf.max(), rel=1e-5)
    assert got[2] == pytest.approx(want[2], rel=1e-4)


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", [
    (0, FreqGrid(-100.0, 100.0, 0.25), 69.25, 202),
    (4, FreqGrid(80.0, 100.0, 0.1), 82.9, 70),
    (6, FreqGrid(-100.0, 100.0, 0.25), -49.75, 15),
])
def test_golden_full_haystack(fixture_pairs, idx, grid, want_freq,
                              want_lag):
    """The untruncated capture file, with the SNR of the JAX package."""
    needle = load_c64(fixture_pairs[idx][0])
    haystack = load_c64(fixture_pairs[idx][1])
    freqs = grid.frequencies(np.float32)
    got = tos.overlap_save_peak(needle, haystack, freqs, FS, with_snr=True,
                                device="cpu")
    want = jos.overlap_save_peak(needle, haystack, freqs, FS, with_snr=True)
    assert got[:2] == want[:2]
    assert got[0] == pytest.approx(want_freq, abs=1e-4)
    assert got[1] == want_lag
    assert got[2] == pytest.approx(want[2], rel=1e-4)
    assert got[3] == pytest.approx(want[3], abs=1e-3)


def test_streaming_peak_masks_and_floor():
    """``streaming_peak`` with a lag offset, a global lag cap, masked
    rows and the floor accumulators, against the JAX scan."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, l = 128, 2000
    needle, hay = _cplx(rng, n), 0.1 * _cplx(rng, l)
    hay[700:700 + n] += needle
    hay[1500:1500 + n] += 2 * needle
    freqs = np.arange(-300.0, 300.0, 100.0, dtype=np.float32)
    rows = np.array([True, False, True, True, True, True])
    m, _, _ = tos.plan_blocks(n, l - n + 1)
    s_t = tos.needle_spectra_conj(torch.from_numpy(needle),
                                  torch.from_numpy(freqs), FS, m)
    from caf_cookoff_tpu.ops.splitfft import split_array

    nr, ni = map(jnp.asarray, split_array(needle))
    s_j = jos.needle_spectra_conj((nr, ni), jnp.asarray(freqs), FS, m,
                                  backend="xla")
    got = tos.streaming_peak(s_t, torch.from_numpy(hay), n, l - n + 1,
                             lag_offset=100, total_lags=1400,
                             valid_rows=torch.from_numpy(rows),
                             with_floor=True)
    want = jos.streaming_peak(s_j, tuple(map(jnp.asarray, split_array(hay))),
                              n, l - n + 1, lag_offset=100, total_lags=1400,
                              backend="xla", valid_rows=jnp.asarray(rows),
                              with_floor=True)
    assert (int(got[0].freq_idx), int(got[0].lag_idx)) == \
        (int(want[0].freq_idx), int(want[0].lag_idx)) == (3, 800)
    assert float(got[0].value) == pytest.approx(float(want[0].value),
                                                rel=1e-4)
    assert float(tos.mean_floor(got[1], got[2])) == pytest.approx(
        float(jos.mean_floor(want[1], want[2])), rel=1e-4)
