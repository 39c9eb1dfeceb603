"""Port's filterbank engine against the JAX package on the golden chirp
fixtures."""

import jax
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.config import CafConfig as JCafConfig
from caf_cookoff_tpu.config import FreqGrid as JFreqGrid
from caf_cookoff_tpu.models import filterbank as jfb
from caf_cookoff_tpu_torch.config import CafConfig, FreqGrid
from caf_cookoff_tpu_torch.models import filterbank as tfb
from caf_cookoff_tpu_torch.utils.convert import caf_config_from_jax

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0

# The golden table of tests/test_golden.py: (chirp, grid, freq, lag).
GOLDEN = [
    (0, FreqGrid(-100.0, 100.0, 0.25), 69.25, 202),
    (1, FreqGrid(-50.0, 50.0, 1.0), 36.0, 78),
    (2, FreqGrid(30.0, 35.0, 0.05), 32.15, 169),
    (3, FreqGrid(-100.0, 100.0, 0.25), -76.25, 151),
    (4, FreqGrid(80.0, 100.0, 0.1), 82.9, 70),
    (5, FreqGrid(-100.0, 100.0, 0.25), -92.75, 177),
    (6, FreqGrid(-100.0, 100.0, 0.25), -49.75, 15),
    (7, FreqGrid(-100.0, 100.0, 0.25), 68.25, 84),
    (8, FreqGrid(-100.0, 100.0, 0.25), -46.25, 80),
    (9, FreqGrid(-100.0, 100.0, 0.5), 61.5, 176),
]


def test_caf_surface_matches_jax(chirp):
    """complex64 surfaces: rtol 1e-4, plus atol 1e-6 x the surface max
    for cells near zero (the two CPU FFT libraries round differently)."""
    needle, haystack, _ = chirp(2)
    freqs = FreqGrid(30.0, 35.0, 0.05).frequencies(np.float32)
    got = tfb.caf_surface(needle, haystack, freqs, FS, backend="xla",
                          device="cpu")
    want = np.asarray(jfb.caf_surface(needle, haystack, freqs, FS,
                                      backend="xla"))
    assert got.shape == want.shape == (100, 8192)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * want.max())
    assert tfb.find_peak(got, freqs) == jfb.find_peak(want, freqs)


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_caf_peak_goldens_match_jax(chirp, idx, grid, want_freq, want_lag):
    """Identical (freq, lag) to JAX and to the golden table; the peak
    value within rtol 1e-4 (same f32 math, other FFT rounding)."""
    needle, haystack, _ = chirp(idx)
    freqs = grid.frequencies(np.float32)
    got = tfb.caf_peak(needle, haystack, freqs, FS, backend="xla",
                       device="cpu")
    want = jfb.caf_peak(needle, haystack, freqs, FS, backend="xla")
    assert got[:2] == want[:2]
    assert got[0] == pytest.approx(want_freq, abs=1e-4)
    assert got[1] == want_lag
    assert got[2] == pytest.approx(want[2], rel=1e-4)


@pytest.mark.parametrize("backend", ["matmul", "matmul-highest",
                                     "matmul-high", "matmul-bf16", "auto"])
def test_fft_backend_aliases_run_full_precision(chirp, backend):
    """Every FFT tier name runs the same full-precision torch.fft."""
    needle, haystack, _ = chirp(0)
    freqs = FreqGrid(60.0, 80.0, 0.25).frequencies(np.float32)
    ref = tfb.caf_peak(needle, haystack, freqs, FS, backend="xla",
                       device="cpu")
    assert tfb.caf_peak(needle, haystack, freqs, FS, backend=backend,
                        device="cpu") == ref
    assert ref[:2] == (69.25, 202)


@pytest.mark.parametrize("backend", ["pallas", "pallas-refine",
                                     "pallas-bf16"])
def test_pallas_backends_not_ported(backend):
    """The pallas* backends, once refused as not ported, now run the
    fused filterbank (its plain version on the CPU) and agree with the
    JAX package's Pallas kernel in interpret mode: identical (freq,
    lag), the unnormalised value within rtol 1e-4 (1e-2 against the
    single-pass bf16 tier), and the surface within rtol 1e-3 + atol
    1e-4 x max (rtol 1e-2 + atol 1e-3 x max against bf16, whose
    rounding error is absolute, ~2^-9 of the row's energy)."""
    rng = np.random.default_rng(11)
    needle = (rng.standard_normal(256)
              + 1j * rng.standard_normal(256)).astype(np.complex64)
    haystack = (np.roll(needle, 21) * np.exp(
        2j * np.pi * 500.0 * np.arange(256) / FS)).astype(np.complex64)
    freqs = np.arange(-1000.0, 1000.0, 250.0, dtype=np.float32)
    bf16 = backend.endswith("bf16")
    rtol = 1e-2 if bf16 else 1e-4
    got = tfb.caf_peak(needle, haystack, freqs, FS, backend=backend,
                       device="cpu")
    want = jfb.caf_peak(needle, haystack, freqs, FS, backend=backend)
    assert got[:2] == want[:2] == (500.0, 21)
    assert got[2] == pytest.approx(want[2], rel=rtol)
    surf = tfb.caf_surface(needle, haystack, freqs, FS, backend=backend,
                           device="cpu")
    jsurf = np.asarray(jfb.caf_surface(needle, haystack, freqs, FS,
                                       backend=backend))
    np.testing.assert_allclose(surf.numpy(), jsurf, rtol=max(rtol, 1e-3),
                               atol=(1e-3 if bf16 else 1e-4) * jsurf.max())


def test_amb_surf_matches_jax(chirp):
    """Python-reference layout: same |xcor| rows (rtol 1e-4, atol 1e-6 x
    max for near-zero cells) and the reference's lag read-out."""
    needle, haystack, truth = chirp(4)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    got = tfb.amb_surf(needle, haystack, freqs, FS, device="cpu").numpy()
    want = np.asarray(jfb.amb_surf(needle, haystack, freqs, FS))
    assert got.shape == want.shape == (len(freqs), len(needle))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())
    fmax, tmax = np.unravel_index(got.argmax(), got.shape)
    assert len(needle) // 2 - tmax == truth.lag_samples == 70
    assert freqs[fmax] == pytest.approx(83.0)


def test_length_mismatch_raises(chirp):
    needle, haystack, _ = chirp(0)
    with pytest.raises(ValueError, match="mismatch"):
        tfb.caf_peak(needle, haystack[:-1], [0.0, 1.0], FS, device="cpu")


def test_c128_filterbank_matches_jax_x64(chirp):
    """complex128 parity mode on chirp_0: the engine object answers the
    golden in both packages, and the c128 surfaces agree to f64
    rounding (rtol 1e-9, atol 1e-12 x max)."""
    needle, haystack, _ = chirp(0)
    grid = FreqGrid(60.0, 80.0, 0.25)
    tcfg = CafConfig(grid=grid, precision="c128")
    with jax.enable_x64(True):
        jcfg = JCafConfig(grid=JFreqGrid(60.0, 80.0, 0.25),
                          precision="c128")
        assert caf_config_from_jax(jcfg) == tcfg
        jeng = jfb.FilterbankCAF(jcfg)
        want_peak = jeng.peak(needle, haystack)
        want = np.asarray(jeng.surface(needle, haystack))
    teng = tfb.FilterbankCAF(tcfg, device="cpu")
    got = teng.surface(needle, haystack)
    assert got.dtype == torch.float64
    assert teng.peak(needle, haystack) == want_peak == (69.25, 202)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-12 * want.max())
    assert tfb.FilterbankCAF(CafConfig(grid=grid), device="cpu").peak(
        needle, haystack) == (69.25, 202)
