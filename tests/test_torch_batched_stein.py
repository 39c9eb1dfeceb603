"""The port's batched engines — the batched Stein engine (config 2), its
banded and windowed long-capture routes (configs 3/4) and the batched
filterbank — against the JAX package on the CPU.

Each case mirrors one of ``tests/test_batched_stein.py`` or
``tests/test_models.py`` and feeds the same numpy inputs to both
packages: the (freq, lag) answers must be identical and the exact
re-score values within rtol 1e-4 (the same f32 filterbank rows, FFTs
rounded in another order).  On the CPU the JAX engines rank with the
kernel's XLA twin, and the port with the kernel's f32 plain version.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models import batched as jb
from caf_cookoff_tpu.models import batched_stein as jbs
from caf_cookoff_tpu.models import filterbank as jfb
from caf_cookoff_tpu.models import overlap_save as jos
from caf_cookoff_tpu.models import stein as jstein
from caf_cookoff_tpu_torch.errors import EligibilityError
from caf_cookoff_tpu_torch.models import _stein_plan as tplan
from caf_cookoff_tpu_torch.models import batched as tb
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import stein as tstein
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.utils.io import load_c64

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0
GRID = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)


def _noise(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _inject(hay, needle, lag, f_hz, amp=1.0):
    span = min(len(needle), len(hay) - lag)
    hay[lag:lag + span] += (amp * needle * np.exp(
        2j * np.pi * f_hz * np.arange(len(needle)) / FS)
    ).astype(np.complex64)[:span]


def _agree(got, want, rel=1e-4):
    """Port and JAX batch answers: identical (freq, lag) per pair,
    values within ``rel``; returns the (freq, lag) pairs."""
    pairs = [(float(f), int(l)) for f, l in zip(got[0], got[1])]
    assert pairs == [(float(f), int(l)) for f, l in zip(want[0], want[1])]
    np.testing.assert_allclose(got[2], want[2], rtol=rel)
    return pairs


def _batched(*args, **kw):
    return _agree(tbs.batched_stein_peak(*args, device="cpu", **kw),
                  jbs.batched_stein_peak(*args, **kw))


def _batched_os(*args, **kw):
    return _agree(tbs.batched_stein_os_peak(*args, device="cpu", **kw),
                  jbs.batched_stein_os_peak(*args, **kw))


def test_batched_matches_single_goldens(chirp):
    idxs = [0, 2, 4, 6, 9]
    needles, hays = zip(*[chirp(i)[:2] for i in idxs])
    got = _batched(np.stack(needles), np.stack(hays), GRID, FS)
    for pair, n, h in zip(got, needles, hays):
        assert pair == tstein.stein_caf_peak(n, h, GRID, FS,
                                             device="cpu")[:2]


def test_batched_fine_grid_golden(chirp):
    """801-bin 0.25 grid (odd K)."""
    freqs = np.arange(-100.0, 100.001, 0.25, dtype=np.float32)
    (n0, h0, _), (n3, h3, _) = chirp(0), chirp(3)
    assert _batched(np.stack([n0, n3]), np.stack([h0, h3]), freqs, FS) == \
        [(69.25, 202), (-76.25, 151)]


def test_batched_negative_lag_circular():
    """An advanced emitter lands in the circular wrap region: the
    extension must reproduce the FFT engine's mod-M indexing."""
    rng = np.random.default_rng(3)
    n = _noise(rng, 4096)
    h = np.zeros(4096, np.complex64)
    h[: 4096 - 300] = n[300:]
    assert _batched(n[None], h[None], GRID, FS) == [(0.0, 8192 - 300)]


def test_batched_coarse_answer_without_refine():
    """``refine=False`` returns the coarse rank's own (bin, lag, value):
    the f32 plain version against JAX's XLA twin."""
    rng = np.random.default_rng(3)
    n = _noise(rng, (2, 4096))
    h = np.zeros((2, 4096), np.complex64)
    h[0, 500:] = n[0, :-500]
    h[1, :-300] = n[1, 300:]
    got = tbs.batched_stein_peak(n, h, GRID, FS, refine=False, device="cpu")
    want = jbs.batched_stein_peak(n, h, GRID, FS, refine=False)
    assert _agree(got, want) == [(0.0, 500), (0.0, 8192 - 300)]


def test_batched_wide_span_small_blocks():
    """+-1500 Hz clamps the block length to 8."""
    rng = np.random.default_rng(4)
    n = _noise(rng, 4096)
    h = np.zeros(4096, np.complex64)
    _inject(h, n, 777, -1250.0)
    freqs = np.arange(-1500.0, 1500.0, 125.0, dtype=np.float32)
    assert _batched(n[None], h[None], freqs, FS) == [(-1250.0, 777)]


def test_batched_banded_wide_span():
    """A span past the pow2 envelope: (pair, band) programs through the
    plain version of K1's ``share_h`` mode, emitters in different
    bands of two pairs."""
    rng = np.random.default_rng(12)
    n = _noise(rng, (2, 2048))
    h = np.zeros((2, 2048), np.complex64)
    _inject(h[0], n[0], 512, 4300.0)
    _inject(h[1], n[1], 64, -5000.0)
    freqs = np.arange(-6000.0, 6000.0, 100.0, dtype=np.float32)
    assert _batched(n, h, freqs, FS) == [(4300.0, 512), (-5000.0, 64)]


def test_batched_shape_validation():
    with pytest.raises(ValueError):
        tbs.batched_stein_peak(np.zeros((2, 64), np.complex64),
                               np.zeros((3, 64), np.complex64), GRID, FS,
                               device="cpu")
    with pytest.raises(EligibilityError):
        tbs.batched_stein_peak(np.ones((1, 100), np.complex64),
                               np.ones((1, 100), np.complex64), GRID, FS,
                               device="cpu")


def test_batched_os_matches_single_chip():
    """Windowed engine: an emitter at the final valid lag and one whose
    correlation straddles a window boundary; the port's exact
    overlap-save scan agrees."""
    rng = np.random.default_rng(8)
    p, n, total = 3, 4096, 32768 + 4096
    lags, f_true = [300, 8190, 32768], [-375.0, 0.0, 375.0]
    needles = _noise(rng, (p, n))
    hays = _noise(rng, (p, total), 1e-4)
    for b in range(p):
        _inject(hays[b], needles[b], lags[b], f_true[b])
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    assert _batched_os(needles, hays, freqs, FS) == list(zip(f_true, lags))
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peak

    assert overlap_save_peak(needles[1], hays[1], freqs, FS,
                             device="cpu")[:2] == (0.0, 8190)


def test_batched_os_golden_fixture(fixture_pairs):
    needle = load_c64(fixture_pairs[0][0])
    full_hay = load_c64(fixture_pairs[0][1])
    freqs = np.arange(-100.0, 100.0, 0.25, dtype=np.float32)
    assert _batched_os(needle[None], full_hay[None], freqs, FS) == \
        [(69.25, 202)]


def test_batched_os_small_needle_and_short_capture():
    """The re-score slices the original needle length (64, padded to
    128), and a capture barely longer than the needle does not
    overrun."""
    rng = np.random.default_rng(17)
    n, total = 64, 4096 + 50
    needle = _noise(rng, n)
    hay = _noise(rng, total, 1e-4)
    _inject(hay, needle, 3000, 750.0)
    freqs = np.arange(-1500.0, 1500.0, 375.0, dtype=np.float32)
    _batched_os(needle[None], hay[None], freqs, FS)
    got = _batched_os(needle[None], hay[None, :n + 8], freqs, FS)
    assert got[0][1] < n + 8


def test_banded_tiny_grid_stays_on_grid():
    """A wide-span grid smaller than the refine width: padded bins never
    reach the exact re-score."""
    rng = np.random.default_rng(18)
    n = 1024
    needle = _noise(rng, n)
    hay = (needle * np.exp(2j * np.pi * 7400.0 * np.arange(n) / FS)
           ).astype(np.complex64)
    freqs = np.arange(-5000.0, 7000.0, 2400.0, dtype=np.float32)
    got = tstein.stein_caf_peak(needle, hay, freqs, FS, device="cpu")
    want = jstein.stein_caf_peak(needle, hay, freqs, FS)
    assert got[:2] == want[:2]
    assert got[0] in [float(f) for f in freqs]
    assert got[2] == pytest.approx(want[2], rel=1e-4)


def test_batched_os_value_full_energy():
    """Refined values are the full-energy exact |R|^2 (the JAX value)."""
    rng = np.random.default_rng(19)
    p, n, total = 2, 2048, 16384
    lags, f_true = [9000, 3333], [250.0, -125.0]
    needles = _noise(rng, (p, n))
    hays = _noise(rng, (p, total), 0.01)
    for b in range(p):
        _inject(hays[b], needles[b], lags[b], f_true[b])
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    assert _batched_os(needles, hays, freqs, FS) == list(zip(f_true, lags))


def test_batched_os_refine_respects_lag_range():
    """A stronger emitter just past ``num_lags`` lies inside the refine
    window of the in-range winner; the reported lag stays in range."""
    rng = np.random.default_rng(21)
    n, total, num_lags = 2048, 16384, 9000
    needle = _noise(rng, n)
    hay = _noise(rng, total, 1e-4)
    hay[8990:8990 + n] += (0.5 * needle).astype(np.complex64)
    hay[9040:9040 + n] += needle
    freqs = np.arange(-250.0, 250.0, 125.0, dtype=np.float32)
    got = _batched_os(needle[None], hay[None], freqs, FS, num_lags=num_lags)
    assert got[0][1] == 8990


def test_banded_os_wide_span_long_capture():
    """A span only the banded windowed engine takes (K1 (c+d) plain)."""
    rng = np.random.default_rng(33)
    n, total = 1024, 10240
    needle = _noise(rng, n)
    hay = _noise(rng, total, 1e-3)
    _inject(hay, needle, 6100, -1650.0)
    freqs = np.arange(-2000.0, 2000.0, 50.0, dtype=np.float32)
    assert _batched_os(needle[None], hay[None], freqs, FS) == \
        [(-1650.0, 6100)]


def test_banded_os_fine_grid_matches_plain():
    """A fine dense grid routes banded on cost; two pairs with emitters
    in different bands and windows."""
    rng = np.random.default_rng(35)
    p, n, total = 2, 1024, 10240
    lags, f_true = [6100, 2333], [-375.5, 411.0]
    needles = _noise(rng, (p, n))
    hays = _noise(rng, (p, total), 1e-3)
    for b in range(p):
        _inject(hays[b], needles[b], lags[b], f_true[b])
    freqs = np.arange(-500.0, 500.0, 0.5, dtype=np.float32)
    assert tplan._band_routing(FS, freqs, 16)[0]
    assert _batched_os(needles, hays, freqs, FS) == list(zip(f_true, lags))


def test_windowed_engine_counts_no_launch_on_cpu():
    """On CPU tensors the engines rank with the plain version: the
    kernel's launch count does not move."""
    rng = np.random.default_rng(2)
    needle = _noise(rng, 512)
    hay = _noise(rng, 3000, 1e-3)
    _inject(hay, needle, 1234, 100.0)
    freqs = np.arange(-200.0, 200.0, 50.0, dtype=np.float32)
    before = tfs.LAUNCHES
    got = tbs.batched_stein_os_peak(needle[None], hay[None], freqs, FS,
                                    device="cpu")
    assert (float(got[0][0]), int(got[1][0])) == (100.0, 1234)
    assert tfs.LAUNCHES == before


def test_band_routing_and_window_extensions_match_jax():
    """The router's choice and arrays, and the per-window haystack
    slices (zero tail), bit for bit."""
    for freqs in (np.arange(-500.0, 500.0, 0.5, dtype=np.float32),
                  np.arange(-2000.0, 2000.0, 50.0, dtype=np.float32),
                  np.arange(-100.0, 100.0, 0.5, dtype=np.float32)):
        for d in (None, 16, 64):
            got = tplan._band_routing(FS, freqs, d)
            want = jstein._band_routing(FS, freqs, d)
            assert got[:2] == want[:2]
            for a, b in zip(got[2:], want[2:]):
                np.testing.assert_array_equal(a, b)
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    hr, hi = (rng.standard_normal((2, 3000)).astype(np.float32)
              for _ in range(2))
    got = tbs._os_window_extensions(torch.from_numpy(hr),
                                    torch.from_numpy(hi), 1024, 3, 1536)
    want = jbs._os_window_extensions(jnp.asarray(hr), jnp.asarray(hi), 1024,
                                     3, 1536)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shift_to_centers_matches_jax():
    """Needles shifted to band centres: the f32 phase in the JAX
    package's order of operations (ulp-level agreement)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    nr, ni = (rng.standard_normal((2, 300)).astype(np.float32)
              for _ in range(2))
    centers = np.array([-5512.5, -11.25, 4987.75], np.float32)
    got = tbs._shift_to_centers(torch.from_numpy(nr), torch.from_numpy(ni),
                                torch.from_numpy(centers), FS)
    want = jbs._shift_to_centers(jnp.asarray(nr), jnp.asarray(ni),
                                 jnp.asarray(centers), FS)
    for g, w in zip(got, want):
        assert g.shape == (6, 384)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# The batched filterbank (tests/test_models.py).

def test_batched_caf_peak_matches_jax(chirp):
    freqs = np.arange(-100.0, 100.0, 0.25, dtype=np.float32)
    needles, hays = zip(*[chirp(i)[:2] for i in (0, 3, 7)])
    got = _agree(tb.batched_caf_peak(np.stack(needles), np.stack(hays),
                                     freqs, FS, device="cpu"),
                 jb.batched_caf_peak(np.stack(needles), np.stack(hays),
                                     freqs, FS))
    for pair, n, h in zip(got, needles, hays):
        assert pair == jfb.caf_peak(n, h, freqs, FS)[:2]


def test_batched_caf_surface_matches_jax(chirp):
    freqs = np.arange(-50, 50, 5.0, dtype=np.float32)
    (n0, h0, _), (n1, h1, _) = chirp(0), chirp(1)
    got = tb.batched_caf_surface(np.stack([n0, n1]), np.stack([h0, h1]),
                                 freqs, FS, device="cpu").numpy()
    want = np.asarray(jb.batched_caf_surface(np.stack([n0, n1]),
                                             np.stack([h0, h1]), freqs, FS))
    assert got.shape == want.shape == (2, 20, 8192)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_batched_caf_shape_validation():
    with pytest.raises(ValueError):
        tb.batched_caf_peak(np.zeros((2, 64), np.complex64),
                            np.zeros((3, 64), np.complex64),
                            np.zeros(4, np.float32), FS, device="cpu")


def test_overlap_save_scan_agrees_on_window_boundary():
    """The exact overlap-save scan of both packages on the boundary
    case of the windowed engine (a correlation straddling 8192)."""
    rng = np.random.default_rng(8)
    n, total = 1024, 6000
    needle = _noise(rng, n)
    hay = _noise(rng, total, 1e-3)
    _inject(hay, needle, 3070, 250.0)
    freqs = np.arange(-500.0, 500.0, 125.0, dtype=np.float32)
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peak

    got = overlap_save_peak(needle, hay, freqs, FS, device="cpu")
    want = jos.overlap_save_peak(needle, hay, freqs, FS, backend="xla")
    assert got[:2] == want[:2] == (250.0, 3070)
    assert got[2] == pytest.approx(want[2], rel=1e-4)
