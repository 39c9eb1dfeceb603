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
from caf_cookoff_tpu_torch.models import _stein_plan as tplan
from caf_cookoff_tpu_torch.models import filterbank as tfb
from caf_cookoff_tpu_torch.models import stein as tstein
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.ops import stein_rescore as trs

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

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


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_stein_peak_goldens_match_jax(chirp, idx, grid, want_freq, want_lag,
                                      fused):
    """``fused=None`` ranks on the CPU with the f32 segmented rows, as
    JAX does there; ``fused=True`` with the fused rank's plain version
    (the kernel's bf16 roundings), ``fused=False`` with the FFT stage A.
    Each must give JAX's and the golden (freq, lag), and the exact
    re-score value within rtol 1e-4 (the same f32 filterbank rows, other
    FFT rounding)."""
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
    got = trs._refine_candidates(torch.from_numpy(scores),
                                 torch.from_numpy(freqs), 4096, FS)
    want = jstein._refine_candidates(jnp.asarray(scores),
                                     jnp.asarray(freqs), 4096, FS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("f_max,requested", [(100.0, 64), (500.0, 64),
                                             (1000.0, 64), (0.0, 32)])
def test_auto_block_len_matches_jax(f_max, requested):
    freqs = np.array([-f_max, 0.0, f_max], np.float32)
    assert tplan._auto_block_len(FS, freqs, requested) == \
        jstein._auto_block_len(FS, freqs, requested)
    assert tplan._pow2_block_len(FS, freqs, requested) == \
        jbs._pow2_block_len(FS, freqs, requested)


def test_pow2_block_len_raises_like_jax():
    freqs = np.array([3000.0], np.float32)   # limit 4 < 8
    with pytest.raises(JSpanError):
        jbs._pow2_block_len(FS, freqs, 64)
    with pytest.raises(SpanError):
        tplan._pow2_block_len(FS, freqs, 64)


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
        tplan._auto_block_len(FS, wide, 64)
    y = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    # A wide uniform grid is banded, as in JAX; pinning the single-band
    # engine (fused=False) raises SpanError in both packages.
    assert tstein.stein_caf_peak(y, y, wide, FS, device="cpu")[:2] == \
        jstein.stein_caf_peak(y, y, wide, FS)[:2]
    with pytest.raises(SpanError):
        tstein.stein_caf_peak(y, y, wide, FS, fused=False, device="cpu")
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


def _cplx(rng, n, scale=1.0):
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _same(got, want, rel=1e-4):
    assert got[:2] == want[:2]
    assert got[2] == pytest.approx(want[2], rel=rel)
    return got[:2]


def test_stein_overlap_save_golden(fixture_pairs):
    """The untruncated capture through the long-capture engine (on the
    CPU: the block-loop scan and the exact window re-score)."""
    from caf_cookoff_tpu.utils.io import load_c64

    needle = load_c64(fixture_pairs[0][0])
    haystack = load_c64(fixture_pairs[0][1])
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    assert _same(tstein.stein_overlap_save_peak(needle, haystack, freqs, FS,
                                                device="cpu"),
                 jstein.stein_overlap_save_peak(needle, haystack, freqs,
                                                FS)) == (69.25, 202)


@pytest.mark.parametrize("refine", [True, False])
def test_stein_overlap_save_synthetic_long(refine):
    """A 65536-sample capture; ``refine=False`` returns the scan's own
    coarse answer (rtol 1e-3: the segment-phase envelope in f32)."""
    rng = np.random.default_rng(5)
    n, total, lag, f_true = 512, 65536, 51_200, -350.0
    needle = _cplx(rng, n)
    hay = _cplx(rng, total, 1e-4)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-400.0, 400.0, 50.0, dtype=np.float32)
    got = tstein.stein_overlap_save_peak(needle, hay, freqs, FS,
                                         refine=refine, device="cpu")
    want = jstein.stein_overlap_save_peak(needle, hay, freqs, FS,
                                          refine=refine)
    assert _same(got, want, rel=1e-4 if refine else 1e-3) == (f_true, lag)


def test_stein_overlap_save_wide_span_runs_banded():
    """A span the scan cannot take routes through the banded windowed
    engine on the CPU too, as in JAX."""
    rng = np.random.default_rng(33)
    n, total, lag, f_true = 1024, 10240, 6100, -1650.0
    needle = _cplx(rng, n)
    hay = _cplx(rng, total, 1e-3)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-2000.0, 2000.0, 50.0, dtype=np.float32)
    assert _same(tstein.stein_overlap_save_peak(needle, hay, freqs, FS,
                                                device="cpu"),
                 jstein.stein_overlap_save_peak(needle, hay, freqs, FS)) \
        == (f_true, lag)
    with pytest.raises(SpanError):
        tstein.stein_overlap_save_peak(needle, hay, freqs, FS, refine=False,
                                       device="cpu")


def test_stein_wide_span_guard():
    """Past the envelope with a correlation length that is no multiple of
    512, both packages raise with a pointer to the exact backends."""
    x = _cplx(np.random.default_rng(6), 128)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    with pytest.raises(JSpanError, match="segmented"):
        jstein.stein_caf_peak(x, x, freqs, FS)
    with pytest.raises(SpanError, match="segmented"):
        tstein.stein_caf_peak(x, x, freqs, FS, device="cpu")


@pytest.mark.parametrize("n,lag,step", [(500, 33, 100.0), (40, 7, 25.0)])
def test_stein_short_and_non_divisible_needles(n, lag, step):
    """A needle length no multiple of the block (500) and one shorter
    than a block (40)."""
    needle = _cplx(np.random.default_rng(9), n)
    hay = np.zeros(n, np.complex64)
    hay[lag:] = needle[:n - lag]
    freqs = np.arange(-5 * step, 5 * step, step, dtype=np.float32)
    assert _same(tstein.stein_caf_peak(needle, hay, freqs, FS, device="cpu"),
                 jstein.stein_caf_peak(needle, hay, freqs, FS)) == (0.0, lag)


@pytest.mark.parametrize("f_true,lag,g0,gs,gk", [
    (4300.0, 512, -6000.0, 100.0, 120), (-9750.0, 64, -10000.0, 250.0, 80)])
def test_banded_wide_span_matches_filterbank(f_true, lag, g0, gs, gk):
    """Spans far past the single-segment envelope run the banded path
    (K1 (c)'s plain version on the CPU) and match JAX and the exact
    filterbank."""
    n = 4096
    needle = _cplx(np.random.default_rng(12), n)
    hay = np.zeros(n, np.complex64)
    hay[lag:] = (needle * np.exp(2j * np.pi * f_true * np.arange(n) / FS)
                 ).astype(np.complex64)[:n - lag]
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    got = tstein.stein_caf_peak(needle, hay, freqs, FS, device="cpu")
    assert _same(got, jstein.stein_caf_peak(needle, hay, freqs, FS)) == \
        (f_true, lag)
    assert tfb.caf_peak(needle, hay, freqs, FS, device="cpu")[:2] == \
        (f_true, lag)


def test_banded_emitters_in_different_bands():
    """Two emitters in different bands: the global top-k ranks across
    bands and the exact re-score picks the stronger."""
    n = 4096
    t = np.arange(n)
    needle = _cplx(np.random.default_rng(13), n)
    hay = np.zeros(n, np.complex64)
    both = (needle * np.exp(2j * np.pi * 5200.0 * t / FS)
            + 0.7 * needle * np.exp(2j * np.pi * -4400.0 * t / FS))
    hay[100:] = both.astype(np.complex64)[:n - 100]
    freqs = np.arange(-6000.0, 6000.0, 200.0, dtype=np.float32)
    assert _same(tstein.stein_caf_peak(needle, hay, freqs, FS, device="cpu"),
                 jstein.stein_caf_peak(needle, hay, freqs, FS)) == \
        (5200.0, 100)


def test_banded_rejected_for_nonuniform_or_explicit_fused():
    needle = _cplx(np.random.default_rng(14), 1024)
    nonuniform = np.array([-9000.0, -100.0, 50.0, 8000.0], np.float32)
    with pytest.raises(SpanError):
        tstein.stein_caf_peak(needle, needle, nonuniform, FS, device="cpu")
    wide = np.arange(-9000.0, 9000.0, 500.0, dtype=np.float32)
    with pytest.raises(SpanError):
        tstein.stein_caf_peak(needle, needle, wide, FS, fused=False,
                              device="cpu")


def test_stein_os_refined_value_full_energy():
    """The refined value is the JAX package's full-energy exact |R|^2."""
    rng = np.random.default_rng(17)
    n, total, lag, f_true = 2048, 16384, 9000, 250.0
    needle = _cplx(rng, n)
    hay = _cplx(rng, total, 0.01)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    assert _same(tstein.stein_overlap_save_peak(needle, hay, freqs, FS,
                                                device="cpu"),
                 jstein.stein_overlap_save_peak(needle, hay, freqs, FS)) \
        == (f_true, lag)


@pytest.mark.parametrize("g,span", [(100.0, 6000.0), (15.0, 6000.0),
                                    (0.5, 500.0), (2.0, 1500.0),
                                    (250.0, 12000.0), (0.5, 10.0)])
def test_plan_bands_matches_jax(g, span):
    """Same band plan (block length, bands, arrays) as the JAX package,
    and the cost-optimal pow2 it tests for."""
    freqs = np.arange(-span, span, g, dtype=np.float32)
    got, want = tplan._plan_bands(FS, freqs), jstein._plan_bands(FS, freqs)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    if (g, span) == (100.0, 6000.0):
        assert got["block_len"] == 16
    assert tplan._plan_bands(FS, freqs[:1]) is None
    assert tplan._plan_bands(FS, freqs[[0, 1, 3]]) is None


def test_segment_spectra_conj_matches_jax():
    import jax.numpy as jnp

    from caf_cookoff_tpu.ops.splitfft import split_array

    needle = _cplx(np.random.default_rng(3), 300)
    got = tstein._segment_spectra_conj(torch.from_numpy(needle), 1024, 64)
    nr, ni = map(jnp.asarray, split_array(needle))
    wr, wi = jstein._segment_spectra_conj((nr, ni), 1024, 64, "xla")
    np.testing.assert_allclose(got.real.numpy(), np.asarray(wr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(wi), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("idx", [0, 3, 9])
def test_stein_peak_wide_doppler_grid_matches_jax(chirp, monkeypatch, idx):
    """``stein_caf_peak`` on the -1000...+995 Hz step-5 grid (400 bins)
    gives JAX's (freq, lag) and the filterbank's, value within rtol 1e-4.
    The grid sets D = 8, so the fused rank holds 2B = 1024 rows: past one
    block's shared memory, K1's plan shares them over a cluster of 2
    blocks a lag tile (``fused=True``: on the CPU its plain version
    runs)."""
    needle, haystack, _ = chirp(idx)
    freqs = FreqGrid(-1000.0, 1000.0, 5.0).frequencies(np.float32)
    shapes = []
    rank = tstein.fused_stein_rank

    def spy(ws1, ws2, lmat, h_ext, b, sup, *args, **kw):
        shapes.append((lmat.shape[1], sup))
        return rank(ws1, ws2, lmat, h_ext, b, sup, *args, **kw)

    monkeypatch.setattr(tstein, "fused_stein_rank", spy)
    got = tstein.stein_caf_peak(needle, haystack, freqs, FS, fused=True,
                                device="cpu")
    want = jstein.stein_caf_peak(needle, haystack, freqs, FS)
    fb = tfb.caf_peak(needle, haystack, freqs, FS, backend="xla",
                      device="cpu")
    assert shapes == [(1024, 8)]
    assert tfs.check_kernel_shape(1024, 8).cluster == 2
    assert got[:2] == want[:2] == fb[:2]
    assert got[2] == pytest.approx(want[2], rel=1e-4)


# Partial-overlap workloads: only the last n - lag needle samples reach
# the haystack, so the true surface is flatter across the grid than the
# bf16 weights' |w|^2 error, and a coarse rank with those roundings picks
# the wrong candidates.  (n, lag, (start, stop, step) Hz, emitter Hz).
PARTIAL = [
    (4096, 3900, (0.0, 50.0, 0.25), 30.0),
    (257, 145, (-6.0, 26.0, 1.0), 19.0),
    (512, 471, (-6.0, 17.0, 1.0), 5.0),
    (777, 656, (-2.0, 6.0, 0.5), 1.0),
    (4096, 3500, (0.0, 50.0, 0.25), 30.0),
]


def _partial_overlap(n, lag, f_hz, seed):
    """A complex-normal needle; a haystack of 1e-3 noise plus the needle's
    first ``n - lag`` samples from ``lag`` on, shifted by ``f_hz``."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-3 * (rng.standard_normal(n)
                   + 1j * rng.standard_normal(n))).astype(np.complex64)
    t = np.arange(n - lag)
    hay[lag:] += (needle[:n - lag] * np.exp(
        2j * np.pi * f_hz * (lag + t) / FS)).astype(np.complex64)
    return needle, hay


@pytest.mark.parametrize("entry", ["stein_caf_peak", "caf_peak",
                                   "stein_overlap_save_peak"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,lag,grid,f_hz", PARTIAL)
def test_partial_overlap_matches_jax(n, lag, grid, f_hz, seed, entry):
    """On the CPU the default coarse rank is JAX's there (f32 segmented
    rows, no bf16 weights), so each entry point gives JAX's (freq, lag)
    on workloads where a bf16 rank picks another bin; value within rtol
    1e-4 (the same exact re-score rows)."""
    needle, hay = _partial_overlap(n, lag, f_hz, seed)
    freqs = np.arange(*grid, dtype=np.float32)
    if entry == "caf_peak":
        got = tfb.caf_peak(needle, hay, freqs, FS, backend="stein",
                           device="cpu")
        want = jfb.caf_peak(needle, hay, freqs, FS, backend="stein")
    else:
        got = getattr(tstein, entry)(needle, hay, freqs, FS, device="cpu")
        want = getattr(jstein, entry)(needle, hay, freqs, FS)
    assert got[:2] == want[:2]
    assert got[1] == lag
    assert got[2] == pytest.approx(want[2], rel=1e-4)
