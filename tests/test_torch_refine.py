"""The port's zoom refinement (``ops/refine``) against the JAX package on
the CPU.

The zooms sum thousands of f32 terms whose scores near the vertex differ
by less than that sum's rounding noise, so two f32 implementations (and
one implementation at two thread counts) land a few mHz apart around
their common answer: on chirp_2 both packages give 32.156146 Hz in f64,
JAX 32.158943 and the port 32.151867 to 32.155003 (by thread count) in
f32, against a truth of 32.16.  So the algorithm is pinned
in f64 (the port on complex128 inputs against JAX with 64-bit types
enabled, within 1e-6 Hz and samples), and in the working f32 both
packages are held to the truth bounds of ``tests/test_refine.py``.
``refine_peak_rate`` ends in the same host f64 polish in both packages,
so its f32 answers agree within 1e-3 Hz, 0.05 Hz/s and 1e-3 samples.
"""

import jax
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models.filterbank import caf_peak as jcaf_peak
from caf_cookoff_tpu.ops import refine as jf
from caf_cookoff_tpu_torch.ops import refine as tf
from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0
GRID = np.arange(-100, 100, 0.5, dtype=np.float32)


@pytest.fixture(scope="module")
def goldens(fixture_pairs):
    """(needle, capture, truth, coarse freq, coarse lag) of the ten
    fixtures, the coarse answer from the 0.5 Hz filterbank."""
    out = []
    for n_path, h_path in fixture_pairs:
        needle, hay = load_c64(n_path), load_c64(h_path)
        f0, lag0, _ = jcaf_peak(needle, hay[:len(needle)], GRID, FS,
                                backend="xla")
        out.append((needle, hay, parse_ground_truth(h_path), f0, lag0))
    return out


def test_refine_peak_f64_matches_jax(goldens):
    """The algorithm, pinned where both packages are deterministic: the
    port on complex128 against JAX in 64-bit, every golden."""
    with jax.enable_x64(True):
        for needle, hay, _, f0, lag0 in goldens:
            nd, hs = needle.astype(np.complex128), hay.astype(np.complex128)
            want = jf.refine_peak(nd, hs, f0, lag0, FS, coarse_step_hz=0.5,
                                  backend="xla")
            got = tf.refine_peak(nd, hs, f0, lag0, FS, coarse_step_hz=0.5,
                                 device="cpu")
            assert abs(got[0] - want[0]) <= 1e-6
            assert abs(got[1] - want[1]) <= 1e-6
            assert got[2] == pytest.approx(want[2], rel=1e-9)


def test_refine_peak_f32_goldens_within_truth(goldens):
    """f32, the working precision: both packages within 0.01 Hz and 0.1
    samples of every fixture's injected truth, values within rtol 1e-4."""
    for needle, hay, gt, f0, lag0 in goldens:
        want = jf.refine_peak(needle, hay, f0, lag0, FS, coarse_step_hz=0.5,
                              backend="xla")
        got = tf.refine_peak(needle, hay, f0, lag0, FS, coarse_step_hz=0.5,
                             device="cpu")
        for f_hat, tau, _ in (got, want):
            assert abs(f_hat - gt.freq_hz) <= 0.01, (gt, got, want)
            assert abs(tau - gt.lag_samples) <= 0.1, (gt, got, want)
        assert got[2] == pytest.approx(want[2], rel=1e-4)


def test_refine_chirp1_coarse_grid(goldens):
    """The reference's own snapping example: +35.99 Hz called 36.0 on a
    1 Hz grid; the zoom recovers 35.99 from that answer."""
    needle, hay, gt, _, _ = goldens[1]
    freqs = np.arange(30.0, 40.0, 1.0, dtype=np.float32)
    f0, lag0, _ = jcaf_peak(needle, hay[:len(needle)], freqs, FS,
                            backend="xla")
    assert f0 == 36.0
    f_hat, tau, _ = tf.refine_peak(needle, hay, f0, lag0, FS,
                                   coarse_step_hz=1.0, device="cpu")
    assert abs(f_hat - 35.99) <= 0.01 and abs(tau - gt.lag_samples) <= 0.1


def _fractional_pair(n=4096, total=16384, lag_frac=1234.375,
                     f_hz=35.9871, seed=3):
    """Needle and capture with a genuine sub-sample delay (a spectral
    phase ramp on a band-limited needle), as ``tests/test_refine.py``."""
    from scipy.signal import filtfilt, firwin

    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    needle = filtfilt(firwin(127, 0.4), 1.0, needle).astype(np.complex64)
    buf = np.zeros(total, np.complex128)
    buf[:n] = needle
    k = np.fft.fftfreq(total) * total
    buf = np.fft.ifft(np.fft.fft(buf)
                      * np.exp(-2j * np.pi * k * lag_frac / total))
    hay = (buf * np.exp(2j * np.pi * f_hz * np.arange(total) / FS)
           ).astype(np.complex64)
    hay += (1e-5 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total))).astype(np.complex64)
    return needle, hay


@pytest.mark.parametrize("lag_true,f_true", [(1234.375, 35.9871),
                                             (777.8, -92.1234),
                                             (500.5, 0.013)])
def test_refine_fractional_delay(lag_true, f_true):
    """Genuine sub-sample delays: the port within 5e-3 Hz and 1e-3
    samples of the truth (the JAX package's own bounds), as JAX is."""
    needle, hay = _fractional_pair(lag_frac=lag_true, f_hz=f_true)
    f0, lag0 = round(f_true * 2) / 2, round(lag_true)
    for f_hat, tau, _ in (
            tf.refine_peak(needle, hay, f0, lag0, FS, coarse_step_hz=0.5,
                           device="cpu"),
            jf.refine_peak(needle, hay, f0, lag0, FS, coarse_step_hz=0.5,
                           backend="xla")):
        assert abs(f_hat - f_true) <= 5e-3
        assert abs(tau - lag_true) <= 1e-3


def test_refine_peaks_batched(goldens):
    """One batched zoom returns each pair's answer: within the truth
    bounds, within the golden contract (0.01 Hz / samples) of the port's
    scalar answers — two f32 programs, each at its own floor (5.2e-3 Hz
    apart on chirp_2 here; the JAX package allows its own pair 5e-3) —
    and in f64 equal to JAX's batched program within 1e-6."""
    rows = goldens[:4]
    length = min(len(r[1]) for r in rows)
    needles = np.stack([r[0] for r in rows])
    hays = np.stack([r[1][:length] for r in rows])
    f0s, lags = [r[3] for r in rows], [r[4] for r in rows]
    fr, lg, vv = tf.refine_peaks(needles, hays, f0s, lags, FS,
                                 coarse_step_hz=0.5, device="cpu")
    assert fr.shape == lg.shape == vv.shape == (4,)
    for i, (_, _, gt, _, _) in enumerate(rows):
        assert abs(fr[i] - gt.freq_hz) <= 0.01
        assert abs(lg[i] - gt.lag_samples) <= 0.1
        scalar = tf.refine_peak(needles[i], hays[i], f0s[i], lags[i], FS,
                                coarse_step_hz=0.5, device="cpu")
        assert abs(fr[i] - scalar[0]) <= 0.01
        assert abs(lg[i] - scalar[1]) <= 0.01
    with jax.enable_x64(True):
        n64, h64 = needles.astype(np.complex128), hays.astype(np.complex128)
        want = jf.refine_peaks(n64, h64, f0s, lags, FS, coarse_step_hz=0.5,
                               backend="xla")
        got = tf.refine_peaks(n64, h64, f0s, lags, FS, coarse_step_hz=0.5,
                              device="cpu")
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-6)


def test_refine_short_capture_and_negative_lag():
    """A needle-length capture at lag 0, and a negative signed lag (the
    capture starts inside the needle): both packages refine against the
    zero-filled, correctly aligned window."""
    rng = np.random.default_rng(11)
    n = 512
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    t = np.arange(n)
    hay0 = (needle * np.exp(2j * np.pi * 25.0 * t / FS)).astype(np.complex64)
    hay_neg = (needle[5:] * np.exp(2j * np.pi * 10.3 * t[5:] / FS)
               ).astype(np.complex64)
    for hay, f0, lag, f_true, tol in ((hay0, 25.0, 0, 25.0, 0.01),
                                      (hay_neg, 10.5, -5, 10.3, 0.02)):
        want = jf.refine_peak(needle, hay, f0, lag, FS, coarse_step_hz=0.5,
                              backend="xla")
        got = tf.refine_peak(needle, hay, f0, lag, FS, coarse_step_hz=0.5,
                             device="cpu")
        for f_hat, tau, _ in (got, want):
            assert abs(f_hat - f_true) <= tol and abs(tau - lag) <= 0.05


def test_extract_window_matches_jax():
    rng = np.random.default_rng(2)
    hay = (rng.standard_normal(300) + 1j * rng.standard_normal(300)
           ).astype(np.complex64)
    for lag in (-40, -3, 0, 5, 150, 280, 400):
        w, start = tf._extract_window(hay, lag, 64)
        w_re, w_im, start_j = jf._extract_window(hay.real, hay.imag, lag, 64)
        assert start == start_j
        np.testing.assert_array_equal(w.real, w_re)
        np.testing.assert_array_equal(w.imag, w_im)


def _swept_capture(f0, rate, lag, n=4096, total=16384, seed=3):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    t_sec = np.arange(n) / FS
    hay = (1e-5 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += (needle * np.exp(2j * np.pi * f0 * t_sec + 1j * np.pi
                                         * rate * t_sec ** 2)
                         ).astype(np.complex64)
    return needle, hay


def _close_rate(got, want):
    assert abs(got[0] - want[0]) <= 1e-3
    assert abs(got[1] - want[1]) <= 0.05
    assert abs(got[2] - want[2]) <= 1e-3
    assert got[3] == pytest.approx(want[3], rel=1e-4)


@pytest.mark.parametrize("f0,rate,lag", [(35.99, 3.7, 1234),
                                          (-92.12, -5.1, 777),
                                          (10.0, 0.0, 500)])
def test_refine_peak_rate_matches_jax(f0, rate, lag):
    """A linear sweep from a first-order engine's mid-window answer: the
    port equals JAX within the stated bounds, and both recover the truth
    as ``tests/test_refine.py`` asks (0.01 Hz, 0.25 Hz/s, 0.01 samples)."""
    needle, hay = _swept_capture(f0, rate, lag)
    f_mean = f0 + rate * (len(needle) / FS) / 2
    args = (needle, hay, round(f_mean * 2) / 2, lag, FS)
    want = jf.refine_peak_rate(*args, coarse_step_hz=0.5, backend="xla")
    got = tf.refine_peak_rate(*args, coarse_step_hz=0.5, device="cpu")
    _close_rate(got, want)
    for f_hat, r_hat, tau, _ in (got, want):
        assert abs(f_hat - f0) <= 0.01 and abs(r_hat - rate) <= 0.25
        assert abs(tau - lag) <= 0.01


def test_refine_peak_rate_bank_chain_and_narrow_bracket():
    """Chained from a rate bank's answer (412 Hz/s, bracket = one 100
    Hz/s step) and with a sub-Hz/s bracket, which the f64 polish must
    both resolve and respect."""
    needle, hay = _swept_capture(20.0, 412.34, 137, total=8192)
    kw = dict(rate0_hz_per_s=400.0, max_rate_hz_per_s=100.0,
              coarse_step_hz=0.5)
    want = jf.refine_peak_rate(needle, hay, 20.5, 137, FS, backend="xla",
                               **kw)
    got = tf.refine_peak_rate(needle, hay, 20.5, 137, FS, device="cpu", **kw)
    _close_rate(got, want)
    assert abs(got[1] - 412.34) <= 0.1 and abs(got[0] - 20.0) <= 0.02
    needle, hay = _swept_capture(20.0, 0.313, 137, total=8192, seed=4)
    got = tf.refine_peak_rate(needle, hay, 20.0, 137, FS, device="cpu",
                              rate0_hz_per_s=0.0, max_rate_hz_per_s=0.5)
    want = jf.refine_peak_rate(needle, hay, 20.0, 137, FS,
                               rate0_hz_per_s=0.0, max_rate_hz_per_s=0.5)
    _close_rate(got, want)
    assert -0.5 <= got[1] <= 0.5 and abs(got[1] - 0.313) <= 1e-3


def test_polish_is_the_jax_packages():
    """The host f64 polish is numpy in both packages: identical output."""
    rng = np.random.default_rng(7)
    n_c = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    g_c = n_c * np.exp(2j * np.pi * (3.0 * np.arange(256) / FS))
    for bounds in (None, (-1.0, 2.0)):
        args = (n_c, g_c, FS, 2.9, 0.5, 0.1, 4.0)
        assert tf._polish_freq_rate_f64(*args, r_bounds=bounds) == \
            jf._polish_freq_rate_f64(*args, r_bounds=bounds)
