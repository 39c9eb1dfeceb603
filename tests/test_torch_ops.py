"""Port's shift, xcor and peak ops against the JAX package on the same
numpy inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.ops import peak as jpeak
from caf_cookoff_tpu.ops import shift as jshift
from caf_cookoff_tpu_torch.ops import peak as tpeak
from caf_cookoff_tpu_torch.ops import shift as tshift

# Both packages' ops re-export a function named xcor over the module.
jxcor = importlib.import_module("caf_cookoff_tpu.ops.xcor")
txcor = importlib.import_module("caf_cookoff_tpu_torch.ops.xcor")

torch.set_num_threads(1)

FS = 48_000.0
# complex64 throughout: the same f32 phase ramp, evaluated by two cos/sin
# and FFT implementations, agrees to a few ulp; rtol 1e-5 of each
# signal's scale (atol) absorbs the cancellation in near-zero cells.
RTOL = 1e-5


def _signal(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_phasor_bank_and_shift_match_jax():
    rng = np.random.default_rng(0)
    freqs = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    _close(tshift.phasor_bank(torch.from_numpy(freqs), 4096, FS),
           jshift.phasor_bank(jnp.asarray(freqs), 4096, FS))
    x = _signal(rng, 4096)
    xt = torch.from_numpy(x)
    _close(tshift.freq_shift(xt, 69.25, FS), jshift.freq_shift(x, 69.25, FS))
    _close(tshift.apply_fdoa(xt, -13.5, FS),
           jshift.apply_fdoa(x, -13.5, FS))
    _close(tshift.shift_bank(xt, torch.from_numpy(freqs[:16]), FS),
           jshift.shift_bank(x, jnp.asarray(freqs[:16]), FS))
    x128 = x.astype(np.complex128)
    got = tshift.freq_shift(torch.from_numpy(x128), 69.25, FS)
    assert got.dtype == torch.complex128


@pytest.mark.parametrize("n", [1000, 4096])
def test_xcor_pair_and_xcor_match_jax(n):
    rng = np.random.default_rng(n)
    a, b = _signal(rng, n), _signal(rng, n)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    _close(txcor.xcor_pair(at, bt), jxcor.xcor_pair(jnp.asarray(a),
                                                    jnp.asarray(b)))
    _close(txcor.xcor(at, bt), jxcor.xcor(jnp.asarray(a), jnp.asarray(b)))
    # Rust operand order: a haystack delayed by D peaks at raw index D.
    h = np.zeros(n, np.complex64)
    h[37:] = b[:n - 37]
    r = txcor.xcor_pair(torch.from_numpy(h), bt)
    assert int(torch.argmax(r.abs())) == 37
    with pytest.raises(ValueError):
        txcor.xcor_pair(at, bt[:-1])


def test_xcor_bank_and_pad_match_jax():
    rng = np.random.default_rng(5)
    h = _signal(rng, 2048)
    s = _signal(rng, 4, 2048)
    spec = np.fft.fft(h).astype(np.complex64)
    _close(txcor.xcor_bank(torch.from_numpy(spec), torch.from_numpy(s)),
           jxcor.xcor_bank(jnp.asarray(spec), jnp.asarray(s)))
    p = txcor.pad_to(torch.from_numpy(s[:, :100]), 128)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jxcor.pad_to(jnp.asarray(s[:, :100]), 128)))
    with pytest.raises(ValueError):
        txcor.pad_to(torch.from_numpy(h), 10)


def test_find_peak_2d_tie_break_lowest_flat_index():
    """Exact ties planted across rows and columns: the lowest flat index
    wins in both packages."""
    rng = np.random.default_rng(1)
    surf = rng.random((9, 64)).astype(np.float32)
    for k, t in [(7, 3), (2, 50), (2, 9), (5, 0)]:
        surf[k, t] = 2.0
    tp = tpeak.find_peak_2d(torch.from_numpy(surf))
    jp = jpeak.find_peak_2d(jnp.asarray(surf))
    assert (int(tp.freq_idx), int(tp.lag_idx)) == (2, 9)
    assert (int(tp.freq_idx), int(tp.lag_idx), float(tp.value)) == \
        (int(jp.freq_idx), int(jp.lag_idx), float(jp.value))
    batched = tpeak.find_peak_2d(torch.from_numpy(np.stack([surf, surf])))
    assert batched.freq_idx.tolist() == [2, 2]


def test_surface_peak_matches_jax():
    """|.|^2 and the global argmax of complex rows: the same (k, tau) as
    JAX's, the value within f32 rounding; an exact tie planted across
    rows goes to the lowest flat index in both."""
    rng = np.random.default_rng(2)
    rows = (rng.standard_normal((7, 256))
            + 1j * rng.standard_normal((7, 256))).astype(np.complex64)
    rows[5, 17] = rows[3, 200] = 9.0 + 9.0j
    tp = tpeak.surface_peak(torch.from_numpy(rows))
    jp = jpeak.surface_peak(jnp.asarray(rows))
    assert (int(tp.freq_idx), int(tp.lag_idx)) == (3, 200)
    assert (int(tp.freq_idx), int(tp.lag_idx)) == (int(jp.freq_idx),
                                                   int(jp.lag_idx))
    assert float(tp.value) == pytest.approx(float(jp.value), rel=1e-6)


def test_lag_helpers_match_jax():
    lags = np.array([0, 5, 4095, 4096, 8000, 8191], np.int32)
    np.testing.assert_array_equal(
        tpeak.signed_lag(torch.from_numpy(lags), 8192, 4096).numpy(),
        np.asarray(jpeak.signed_lag(jnp.asarray(lags), 8192, 4096)))
    for raw in lags.tolist():
        assert tpeak.unwrap_lag(raw, 8192, 4096) == \
            jpeak.unwrap_lag(raw, 8192, 4096)
    freqs = np.arange(-10.0, 10.0, 0.5, dtype=np.float32)
    idx = np.array([0, 3, 39], np.int32)
    np.testing.assert_array_equal(
        tpeak.grid_frequency(torch.from_numpy(idx),
                             torch.from_numpy(freqs)).numpy(),
        np.asarray(jpeak.grid_frequency(jnp.asarray(idx),
                                        jnp.asarray(freqs))))


@pytest.mark.parametrize("k,sep", [(4, 0), (4, 3), (6, 10), (3, 100)])
def test_topk_separated_matches_jax(k, sep):
    rng = np.random.default_rng(7)
    vals = rng.random(64).astype(np.float32)
    vals[[10, 11, 40]] = 5.0          # planted exact ties
    got = tpeak.topk_separated(torch.from_numpy(vals), k, sep)
    want = jpeak.topk_separated(jnp.asarray(vals), k, sep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,stop,step,n", [
    (-100.0, 100.0, 0.5, 4096), (-100.0, 100.0, 0.25, 4096),
    (30.0, 35.0, 0.05, 4096), (0.0, 1.0, 1.0, 4096), (-50.0, 50.0, 20.0, 64)])
def test_doppler_cell_bins_matches_jax(start, stop, step, n):
    freqs = np.arange(start, stop, step, dtype=np.float32)
    got = tpeak.doppler_cell_bins(torch.from_numpy(freqs), n, FS)
    want = jpeak.doppler_cell_bins(jnp.asarray(freqs), n, FS)
    assert int(got) == int(want)
    assert got.dtype == torch.int32
