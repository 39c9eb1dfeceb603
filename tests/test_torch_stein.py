"""Port's segmented (Stein) engine — the main path — against the JAX
package on the golden chirp fixtures, plus the port's CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu import cli as jcli
from caf_cookoff_tpu.errors import SpanError as JSpanError
from caf_cookoff_tpu.models import batched_stein as jbs
from caf_cookoff_tpu.models import filterbank as jfb
from caf_cookoff_tpu.models import stein as jstein
from caf_cookoff_tpu_torch import cli as tcli
from caf_cookoff_tpu_torch.config import FreqGrid
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import filterbank as tfb
from caf_cookoff_tpu_torch.models import stein as tstein

torch.set_num_threads(1)

FS = 48_000.0

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


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_stein_peak_goldens_match_jax(chirp, idx, grid, want_freq, want_lag,
                                      fused):
    """``fused=None`` takes the fused rank (its plain version on the
    CPU), ``fused=False`` the FFT stage A; both must give JAX's and the
    golden (freq, lag), and the exact re-score value within rtol 1e-4
    (the same f32 filterbank rows, other FFT rounding)."""
    needle, haystack, _ = chirp(idx)
    freqs = grid.frequencies(np.float32)
    got = tstein.stein_caf_peak(needle, haystack, freqs, FS, fused=fused,
                                device="cpu")
    want = jstein.stein_caf_peak(needle, haystack, freqs, FS)
    assert got[:2] == want[:2]
    assert got[0] == pytest.approx(want_freq, abs=1e-4)
    assert got[1] == want_lag
    assert got[2] == pytest.approx(want[2], rel=1e-4)


def test_caf_peak_stein_backends(chirp):
    """``caf_peak(backend='stein')`` is the main path; 'stein-raw' ranks
    without the exact re-score, as in JAX."""
    needle, haystack, _ = chirp(0)
    freqs = FreqGrid(-100.0, 100.0, 0.5).frequencies(np.float32)
    for backend in ("stein", "stein-raw"):
        got = tfb.caf_peak(needle, haystack, freqs, FS, backend=backend,
                           device="cpu")
        want = jfb.caf_peak(needle, haystack, freqs, FS, backend=backend)
        assert got[:2] == want[:2]
        assert got[1] == 202
        # stein-raw reports the coarse (segment-phase) value: rtol 1e-3
        # as for the coarse surface below.
        assert got[2] == pytest.approx(want[2], rel=1e-3)


def test_stein_surface_matches_jax(chirp):
    """Coarse Stein surface: rtol 1e-3, atol 1e-5 x max (the same
    segment-phase envelope math in f32, FFTs rounded differently)."""
    needle, haystack, _ = chirp(3)
    freqs = FreqGrid(-80.0, -70.0, 0.25).frequencies(np.float32)
    got = tstein.stein_caf_surface(needle, haystack, freqs, FS,
                                   device="cpu").numpy()
    want = np.asarray(jstein.stein_caf_surface(needle, haystack, freqs, FS))
    assert got.shape == want.shape == (40, 8192)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * want.max())
    via_fb = tfb.caf_surface(needle, haystack, freqs, FS, backend="stein",
                             device="cpu").numpy()
    np.testing.assert_array_equal(via_fb, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_candidates_match_jax(seed):
    """Same candidate list (top-8 with ties lowest bin first, then the
    mainlobe-separated top-4) on a score vector with planted ties."""
    rng = np.random.default_rng(seed)
    scores = rng.random(200).astype(np.float32)
    scores[[3, 50, 51, 120, 199]] = 7.0
    scores[[10, 11]] = 6.5
    freqs = np.arange(-50.0, 50.0, 0.5, dtype=np.float32)
    got = tstein._refine_candidates(torch.from_numpy(scores),
                                    torch.from_numpy(freqs), 4096, FS)
    want = jstein._refine_candidates(jnp.asarray(scores),
                                     jnp.asarray(freqs), 4096, FS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("f_max,requested", [(100.0, 64), (500.0, 64),
                                             (1000.0, 64), (0.0, 32)])
def test_auto_block_len_matches_jax(f_max, requested):
    freqs = np.array([-f_max, 0.0, f_max], np.float32)
    assert tstein._auto_block_len(FS, freqs, requested) == \
        jstein._auto_block_len(FS, freqs, requested)
    assert tbs._pow2_block_len(FS, freqs, requested) == \
        jbs._pow2_block_len(FS, freqs, requested)


def test_pow2_block_len_raises_like_jax():
    freqs = np.array([3000.0], np.float32)   # limit 4 < 8
    with pytest.raises(JSpanError):
        jbs._pow2_block_len(FS, freqs, 64)
    with pytest.raises(SpanError):
        tbs._pow2_block_len(FS, freqs, 64)


def test_errors_where_jax_raises():
    """The cases of tests/test_errors.py: an ineligible fused flag raises
    EligibilityError, a span past the envelope raises SpanError."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100)
         + 1j * rng.standard_normal(100)).astype(np.complex64)
    freqs = np.arange(-10.0, 10.0, 1.0, dtype=np.float32)
    with pytest.raises(EligibilityError):
        tstein.stein_caf_peak(x, x, freqs, FS, fused=True, device="cpu")
    wide = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    with pytest.raises(SpanError):
        tstein._auto_block_len(FS, wide, 64)
    y = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    with pytest.raises(SpanError, match="banded Stein"):
        tstein.stein_caf_peak(y, y, wide, FS, device="cpu")
    with pytest.raises(ValueError):
        tstein.stein_caf_peak(y, y[:100], freqs, FS, device="cpu")
    # fused=False on the ineligible shape is the unfused engine.
    assert tstein.stein_caf_peak(x, x, freqs, FS, fused=False,
                                 device="cpu")[1] == 0


def test_cli_run_prints_jax_result_lines(fixture_pairs, capsys, tmp_path):
    needle, haystack = fixture_pairs[0]
    args = ["run", str(needle), str(haystack), "--freq-step", "0.25",
            "--backend", "stein"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.splitlines()[:2]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == want
    assert got[0] == "Frequency offset: 69.250 Hz"
    assert tcli.main(["generate", "--out", str(tmp_path), "--count", "2"]) \
        == 0
    assert len(list(tmp_path.glob("chirp_*_T*samp_F*Hz.c64"))) == 2
