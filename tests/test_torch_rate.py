"""The port's rate engines (``models/rate``) and K1 mode (f) against the
JAX package on the CPU.

Each case feeds the same numpy inputs, made from a seed, to both
packages.  Engine answers (rate, freq, lag) and lattice rows must be
identical, values within rtol 1e-4 (the same f32 exact re-score rows,
FFTs summed in another order).  The JAX engines rank with their XLA twin
on the CPU and the port's with K1's f32 plain version; emitters are
planted well apart, so only re-scored answers are held identical.  K1
mode (f)'s plain version is held to the XLA twin (f32, rtol 1e-4) and to
the Pallas kernel in interpret mode (bf16 roundings, rtol 2e-2, lags
identical) — the tolerances of the other K1 tests.  The kernel itself is
held to its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.errors import SpanError as JSpanError
from caf_cookoff_tpu.models import batched_stein as jbs
from caf_cookoff_tpu.models import rate as jr
from caf_cookoff_tpu.models import stein as jst
from caf_cookoff_tpu.ops import pallas_stein as jps
from caf_cookoff_tpu.ops.splitfft import split_array
from caf_cookoff_tpu_torch.errors import SpanError
from caf_cookoff_tpu_torch.models import _stein_plan as tplan
from caf_cookoff_tpu_torch.models import rate as tr
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.utils.convert import stein_operands_from_numpy

torch.set_num_threads(1)

FS = 48_000.0
VALUE_RTOL = 1e-4
RATES = np.arange(-240.0, 241.0, 120.0, dtype=np.float32)       # R = 5


def _noise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _swept(emitters, n=1024, total=8192, seed=8, noise=1e-4):
    """(needle, capture): swept copies (f0 at the window start, rate
    Hz/s, lag, amplitude) over a noise floor."""
    rng = np.random.default_rng(seed)
    needle = _noise(rng, n)
    hay = (noise * _noise(rng, total)).astype(np.complex64)
    t = np.arange(n)
    for f0, rate, lag, amp in emitters:
        ph = 2 * np.pi * f0 * t / FS + np.pi * rate * (t / FS) ** 2
        end = min(lag + n, total)
        hay[lag:end] += (amp * needle * np.exp(1j * ph)).astype(
            np.complex64)[:end - lag]
    return needle, hay


# ---------------------------------------------------------------------------
# Synthesis rows, band plans, routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,rates,b,d", [
    (24, RATES, 16, 64), (7, np.array([0.0], np.float32), 32, 128),
    (40, np.array([-600.0, 35.5, 400.25], np.float32), 8, 8)])
def test_rate_synthesis_weights_match_jax(k, rates, b, d):
    freqs = np.linspace(-300.0, 300.0, k).astype(np.float32)
    want = jps.stein_rate_synthesis_weights(jnp.asarray(freqs),
                                            jnp.asarray(rates), FS, b, d)
    got = tfs.stein_rate_synthesis_weights(torch.from_numpy(freqs), rates,
                                           FS, b, d)
    for g, w in zip(got, want):
        assert g.shape == (len(rates) * k, 2 * b)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # Rate-major rows: row i*K + k is (rate i, bin k).
    one = tfs.stein_rate_synthesis_weights(torch.from_numpy(freqs),
                                           rates[-1:], FS, b, d)
    np.testing.assert_array_equal(got[0][-k:].numpy(), one[0].numpy())


BAND_CASES = [
    (np.linspace(-500, 500, 2000, endpoint=False), 0.0, None),
    (np.linspace(-500, 500, 2000, endpoint=False), 17.07, 1697),
    (np.linspace(-500, 500, 400, endpoint=False), 10.24, None),
    (np.arange(-100, 100, 0.5), 0.0, 16),
    (np.arange(-100, 100, 0.5), 30.0, 100),
    (np.arange(-100, 100, 0.5), 2000.0, None),         # every width <= 0
    (np.arange(-100, 100, 0.5), 0.0, 7),                # every D capped
    (np.arange(20000.0, 22001.0, 500.0), 0.0, None),
    (np.array([0.0, 1.0, 3.0]), 0.0, None),             # not uniform
]


@pytest.mark.parametrize("freqs,margin,d_cap", BAND_CASES)
def test_plan_bands_and_routing_match_jax(freqs, margin, d_cap):
    freqs = np.asarray(freqs, np.float32)
    want = jst._plan_bands(FS, freqs, margin_hz=margin, d_cap=d_cap)
    got = tplan._plan_bands(FS, freqs, margin_hz=margin, d_cap=d_cap)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))
    for d in (None, 8, 64):
        want = jst._band_routing(FS, freqs, d, margin_hz=margin, d_cap=d_cap)
        got = tplan._band_routing(FS, freqs, d, margin_hz=margin, d_cap=d_cap)
        assert got[:2] == want[:2]
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("freqs,rates,n,hay_len", [
    (np.arange(-100, 100, 0.5), RATES, 2048, 16384),
    (np.linspace(-500, 500, 2000, endpoint=False),
     np.arange(-200.0, 201.0, 50.0), 4096, 69632),
    (np.linspace(-500, 500, 400, endpoint=False), RATES, 2048, 2049),
    (np.arange(-100, 100, 1.0), np.array([0.0]), 1024, 8192),
    (np.arange(-100, 100, 1.0), np.array([4000.0]), 4096, 9000),
    (np.arange(20000.0, 22001.0, 500.0), np.array([0.0]), 2048, 8192),
])
def test_rate_block_len_routing_and_keys_match_jax(freqs, rates, n, hay_len):
    freqs = np.asarray(freqs, np.float32)
    rates = np.asarray(rates, np.float32)
    for req in (64, 128):
        try:
            want = jr._rate_block_len(FS, freqs, rates, n, req)
        except JSpanError:
            with pytest.raises(SpanError):      # the banded route's case
                tr._rate_block_len(FS, freqs, rates, n, req)
        else:
            assert tr._rate_block_len(FS, freqs, rates, n, req) == want
    want = jr._rate_routing(FS, freqs, rates, n, 64, hay_len)
    got = tr._rate_routing(FS, freqs, rates, n, 64, hay_len)
    # JAX's rows per launch (its VMEM budget) is not carried over; the
    # port's comes from _rate_chunk.
    assert got[0] == want[0] and got[4] == want[5]
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    assert tr._rate_grid_half_t_bins(freqs, n, FS) == \
        jr._rate_grid_half_t_bins(freqs, n, FS)
    assert tr._rate_grid_half_t_bins(freqs[:1], n, FS) == \
        jr._rate_grid_half_t_bins(freqs[:1], n, FS)


def test_rate_block_len_span_errors_match_jax():
    wide = np.asarray([23000.0], np.float32)
    for rates in (np.asarray([0.0]), np.asarray([90000.0])):
        with pytest.raises(JSpanError):
            jr._rate_block_len(FS, wide, rates, 4096, 128)
        with pytest.raises(SpanError):
            tr._rate_block_len(FS, wide, rates, 4096, 128)
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    assert tr._rate_block_len(FS, freqs, np.asarray([4000.0]), 4096, 128) \
        <= tr._rate_block_len(FS, freqs, np.asarray([0.0]), 4096, 128)


def test_rate_chunk_sizes_launches_by_partials():
    """Rows per K1 launch: the 1 GiB partials budget takes rate3's 9
    rates (306-bin bands x 56 programs x 8192 lags: 8.8 MB a rate) in
    one launch; a budget below one rate still launches one rate."""
    assert tr._rate_chunk(306, 56, 8192) == (1 << 30) // (306 * 56 * 64 * 8)
    assert tr._rate_chunk(306, 56, 8192) >= 9
    assert tr._rate_chunk(10 ** 6, 10 ** 3, 8192) == 1


_JAX_MERGE_RATE = jax.jit(jr._merge_rate_lattice,
                          static_argnums=(6, 7, 8))


@pytest.mark.parametrize("seed", range(4))
def test_merge_rate_lattice_fuzz_with_ties(seed):
    """Seeded candidate sets full of tied values, keys, lags and rates,
    some -inf, 1-5 slots (never more than candidates, as in the engines):
    the port's host merge equals the JAX scan field for field."""
    rng = np.random.default_rng(40 + seed)
    for trial in range(12):
        c = (4, 10, 27)[trial % 3]
        p = int(rng.integers(1, min(6, c + 1)))
        v = rng.integers(0, 4, c).astype(np.float32)
        v[rng.random(c) < 0.2] = -np.inf
        key = rng.integers(0, 12, c).astype(np.int32)
        lag = rng.integers(0, 30, c).astype(np.int32)
        ridx = rng.integers(0, 5, c).astype(np.int32)
        fws = rng.integers(0, 12, c).astype(np.int32)
        rv = (np.asarray([-240.0, -120.0, 0.0, 120.0, 240.0],
                         np.float32)[ridx])
        htb = np.float32(rng.choice([0.0, 0.0107, 0.0427]))
        ef, el = ((0, 1), (1, 3), (2, 2))[trial % 3]
        want = _JAX_MERGE_RATE(jnp.asarray(v), jnp.asarray(key),
                               jnp.asarray(lag), jnp.asarray(ridx),
                               jnp.asarray(fws), jnp.asarray(rv), p, ef, el,
                               jnp.asarray(htb))
        got = tr._merge_rate_lattice(v, key, lag, ridx, fws, rv, p, ef, el,
                                     htb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# K1 mode (f): the plain version at tall rows
# ---------------------------------------------------------------------------


def _rate_operands(s, w, kb, rates, n=512, d=64, v=1024, seed=0,
                   needles=None, hays=None):
    """JAX-built K1 (c+d+f) operands for one pair: S band needles, W
    windows, rate-major rows over a ``kb``-bin relative grid; returns
    (ops, b, sup, num_valid, the XLA twin's per-program operands)."""
    rng = np.random.default_rng(seed)
    needles = _noise(rng, (s, n)) if needles is None else needles
    hays = _noise(rng, (1, w * v + n)) if hays is None else hays
    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    hs_re, hs_im = map(jnp.asarray, split_array(hays))
    b = n // d
    lmat, sup = jbs._needle_operator(ns_re, ns_im, d)
    h_ext = jbs._os_window_extensions(hs_re, hs_im, v, w,
                                      jps.fused_span(b, sup, v))
    rel = np.linspace(-150, 150, kb).astype(np.float32)
    ws1, ws2 = jps.stein_rate_synthesis_weights(rel, rates, FS, b, d)
    total = w * v - 300
    nv = np.tile(np.clip(total - np.arange(w) * v, 0, v), s).astype(np.int32)
    reps = (jnp.repeat(lmat, w, axis=0), jnp.tile(h_ext, (s, 1, 1)))
    return (ws1, ws2, lmat, h_ext), b, sup, nv, reps


@pytest.mark.parametrize("top2", [False, True])
def test_rate_rows_plain_f32_matches_xla_twin(top2):
    """K1's f32 plain version at (c+d+f) with 5 rates x 24 bins = 120
    rows, 2 bands x 2 windows (the last cut to 724 lags), single and
    top-2: against ``_coarse_rank_xla`` fed per-program operands, as the
    JAX rate engines' CPU route feeds it; values rtol 1e-4, every lag
    identical."""
    s, w, v, sep = 2, 2, 1024, 5
    ops, b, sup, nv, reps = _rate_operands(s, w, 24, RATES)
    want = jbs._coarse_rank_xla(ops[0], ops[1], *reps, b, sup, v,
                                num_valid=jnp.asarray(nv), want_top2=top2,
                                sep=sep)
    got = tfs.coarse_rank_plain(*stein_operands_from_numpy(*ops,
                                                           device="cpu"),
                                b, sup, v, windows=w, share_h=s,
                                num_valid=nv, want_top2=top2, sep=sep)
    assert got[0].shape == (len(RATES) * 24, s * w)
    for slot in range(len(want)):
        if slot % 2:
            np.testing.assert_array_equal(got[slot].numpy(),
                                          np.asarray(want[slot]))
        else:
            np.testing.assert_allclose(got[slot].numpy(),
                                       np.asarray(want[slot]), rtol=1e-4)


@pytest.mark.parametrize("top2", [False, True])
def test_rate_rows_plain_bf16_matches_pallas_kernel(top2):
    """The plain version with the kernel's bf16 roundings against JAX's
    Pallas kernel in interpret mode at a tiny (f) shape (3 rates x 16
    bins, 2 bands, 2 windows): impulse needles against two spikes a
    window more than 2*sep apart, so every lag is unambiguous; lags
    identical, values within the JAX package's 2e-2."""
    s, w, n, v, sep = 2, 2, 512, 1024, 4
    needles = np.zeros((s, n), np.complex64)
    needles[0, 0], needles[1, 7] = 1.0, 1.0
    hays = np.zeros((1, w * v + n), np.complex64)
    for win in range(w):
        hays[0, win * v + 101 + 29 * win] = 2.0
        hays[0, win * v + 503] = 3.0 if win else 1.0
    rates = np.asarray([-300.0, 0.0, 250.0], np.float32)
    ops, b, sup, nv, _ = _rate_operands(s, w, 16, rates, needles=needles,
                                        hays=hays)
    want = jps.fused_stein_rank(*ops, b, sup, v, interpret=True, windows=w,
                                share_h=s, num_valid=jnp.asarray(nv),
                                want_top2=top2, sep=sep)
    got = tfs.fused_stein_rank(*stein_operands_from_numpy(*ops,
                                                          device="cpu"),
                               b, sup, v, windows=w, share_h=s, num_valid=nv,
                               want_top2=top2, sep=sep)
    for slot in range(len(want)):
        if slot % 2:
            np.testing.assert_array_equal(got[slot].numpy(),
                                          np.asarray(want[slot]))
        else:
            np.testing.assert_allclose(got[slot].numpy(),
                                       np.asarray(want[slot]), rtol=2e-2)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _same_answer(got, want):
    assert got[:3] == want[:3]
    np.testing.assert_allclose(got[3], want[3], rtol=VALUE_RTOL)


def test_rate_caf_peak_matches_jax():
    """The dechirp bank on a needle-length window: a 412 Hz/s sweep
    (~35 bins of smear at 0.25 Hz over 43 ms) and an unswept emitter."""
    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    rates = np.arange(-600.0, 601.0, 200.0)
    for f0, rate, lag in ((20.0, 412.34, 137), (-41.5, 0.0, 70)):
        needle, hay = _swept([(f0, rate, lag, 1.0)], n=2048, total=2048,
                             seed=3)
        want = jr.rate_caf_peak(needle, hay, freqs, rates, FS, backend="xla")
        got = tr.rate_caf_peak(needle, hay, freqs, rates, FS, device="cpu")
        _same_answer(got, want)
        assert got[2] == lag
    assert got[0] == 0.0


@pytest.mark.parametrize("num_lags", [None, 5000])
def test_rate_overlap_save_peak_matches_jax(num_lags):
    """The serial engine: the stronger emitter past the lag bound must
    not be reported when ``num_lags`` cuts it off."""
    freqs = np.arange(-100, 100, 1.0, dtype=np.float32)
    needle, hay = _swept([(30.0, 120.0, 6000, 1.0),
                          (-50.0, -120.0, 3000, 0.5)])
    want = jr.rate_overlap_save_peak(needle, hay, freqs, RATES, FS,
                                     num_lags=num_lags, backend="xla")
    got = tr.rate_overlap_save_peak(needle, hay, freqs, RATES, FS,
                                    num_lags=num_lags, device="cpu")
    _same_answer(got, want)
    assert got[:3] == ((120.0, 30.0, 6000) if num_lags is None
                       else (-120.0, -50.0, 3000))


@pytest.mark.parametrize("case", ["plain", "banded", "num_lags", "pad_bins"])
def test_stein_rate_os_peak_matches_jax(case):
    """The segmented engine (K1 (c+d+f) on the CPU through its plain
    version) against JAX's, and both against the serial engine: a plain
    grid, a wide grid that bands with the rate drift in its envelope, a
    lag bound, and a banded grid whose pad bins must stay off the grid."""
    if case == "pad_bins":
        freqs = np.arange(20000.0, 22001.0, 500.0, dtype=np.float32)
        rates = np.asarray([0.0], np.float32)
        needle, hay = _swept([(22400.0, 0.0, 3000, 1.0)], seed=3)
        assert tplan._band_routing(FS, freqs, None)[0]
    elif case == "banded":
        freqs = np.linspace(-500, 500, 256, endpoint=False).astype(np.float32)
        rates = RATES
        needle, hay = _swept([(float(freqs[201]), -240.0, 5000, 1.0)],
                             seed=2)
        assert tr._rate_routing(FS, freqs, rates, 1024, 64,
                                len(hay))[2].shape[0] > 1
    else:
        freqs = np.arange(-100, 100, 1.0, dtype=np.float32)
        rates = RATES
        needle, hay = _swept([(30.0, 120.0, 6000, 1.0),
                              (-50.0, -120.0, 3000, 0.5)])
    num_lags = 5000 if case == "num_lags" else None
    want = jr.stein_rate_os_peak(needle, hay, freqs, rates, FS,
                                 num_lags=num_lags)
    got = tr.stein_rate_os_peak(needle, hay, freqs, rates, FS,
                                num_lags=num_lags, device="cpu")
    _same_answer(got, want)
    serial = tr.rate_overlap_save_peak(needle, hay, freqs, rates, FS,
                                       num_lags=num_lags, device="cpu")
    assert got[:3] == serial[:3]
    assert float(got[1]) in set(float(f) for f in freqs)


def test_stein_rate_span_error_matches_jax():
    """A grid that neither fits the rate-augmented envelope nor bands
    (not uniform): both packages raise SpanError, which the CLI routes to
    the serial engine."""
    freqs = np.asarray([0.0, 23000.0, 23001.5], np.float32)
    needle, hay = _swept([])
    with pytest.raises(JSpanError):
        jr.stein_rate_os_peak(needle, hay, freqs, RATES, FS)
    for fn in (tr.stein_rate_os_peak, tr.stein_rate_os_peaks):
        with pytest.raises(SpanError, match="does not pay off"):
            fn(needle, hay, freqs, RATES, FS,
               *(() if fn is tr.stein_rate_os_peak else (2,)), device="cpu")


def _rows(out):
    return [(float(r), float(f), int(l))
            for r, f, l, v in zip(*out[:4]) if np.isfinite(float(v))]


def _same_lattice(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    fin = np.isfinite(np.asarray(want[3]))
    np.testing.assert_array_equal(np.isfinite(got[3]), fin)
    np.testing.assert_allclose(got[3][fin], np.asarray(want[3])[fin],
                               rtol=VALUE_RTOL)
    if len(want) > 4:
        np.testing.assert_allclose(got[4][fin], np.asarray(want[4])[fin],
                                   atol=1e-3)


TWO = [(25.0, 120.0, 3000, 1.0), (-60.0, -120.0, 6500, 0.6)]


@pytest.mark.parametrize("name", ["rate_overlap_save_peaks",
                                  "stein_rate_os_peaks"])
def test_rate_lattices_match_jax(name):
    """Two accelerating emitters: both lattice engines list them as their
    first rows with JAX's (rate, freq, lag) rows, values and SNRs; with
    the auto threshold every listed slot passes; num_peaks=1 is the
    single-peak engine's answer."""
    freqs = np.arange(-100, 100, 1.0, dtype=np.float32)
    needle, hay = _swept(TWO)
    kw = dict(min_snr_db="auto", with_snr=True)
    want = getattr(jr, name)(needle, hay, freqs, RATES, FS, 3, **kw)
    got = getattr(tr, name)(needle, hay, freqs, RATES, FS, 3, device="cpu",
                            **kw)
    _same_lattice(got, want)
    assert _rows(got)[:2] == [(r, f, lag) for f, r, lag, _ in TWO]
    single = (tr.rate_overlap_save_peak if name.startswith("rate")
              else tr.stein_rate_os_peak)(needle, hay, freqs, RATES, FS,
                                          device="cpu")
    one = getattr(tr, name)(needle, hay, freqs, RATES, FS, 1, device="cpu")
    assert _rows(one) == [single[:3]]


@pytest.mark.parametrize("name", ["rate_overlap_save_peaks",
                                  "stein_rate_os_peaks"])
def test_rate_lattices_noise_only_zero_detections(name):
    rng = np.random.default_rng(9)
    needle = _noise(rng, 1024)
    noise = (1e-3 * _noise(rng, 8192)).astype(np.complex64)
    freqs = np.arange(-100, 100, 1.0, dtype=np.float32)
    want = getattr(jr, name)(needle, noise, freqs, RATES, FS, 3,
                             min_snr_db="auto", with_snr=True)
    got = getattr(tr, name)(needle, noise, freqs, RATES, FS, 3,
                            min_snr_db="auto", with_snr=True, device="cpu")
    assert not np.isfinite(got[3]).any() and not np.isfinite(want[3]).any()
    np.testing.assert_array_equal(np.isfinite(got[4]),
                                  np.isfinite(np.asarray(want[4])))


def test_stein_rate_lattice_banded_matches_jax():
    """A banded grid through K1 (c+d+e+f): the lattice rows equal JAX's
    and the serial lattice's."""
    freqs = np.linspace(-500, 500, 256, endpoint=False).astype(np.float32)
    emitters = [(float(freqs[40]), 120.0, 2500, 1.0),
                (float(freqs[190]), -240.0, 9000, 0.6)]
    # 2048 samples: rates 120 Hz/s apart are resolvable (a 0.17 rad
    # quadratic phase at the window's edges).
    needle, hay = _swept(emitters, n=2048, total=16384, seed=4)
    want = jr.stein_rate_os_peaks(needle, hay, freqs, RATES, FS, 3)
    got = tr.stein_rate_os_peaks(needle, hay, freqs, RATES, FS, 3,
                                 device="cpu")
    _same_lattice(got, want)
    serial = tr.rate_overlap_save_peaks(needle, hay, freqs, RATES, FS, 3,
                                        device="cpu")
    assert _rows(got)[:2] == _rows(serial)[:2] == [
        (r, f, lag) for f, r, lag, _ in emitters]


def test_chunking_does_not_change_answers(monkeypatch):
    """Rows are independent: K1 in one launch or in one launch per rate,
    and the serial engines' rates in one batch or one at a time, give the
    same answers."""
    freqs = np.arange(-100, 100, 1.0, dtype=np.float32)
    needle, hay = _swept(TWO)
    calls = []
    real = tr._coarse_rank
    monkeypatch.setattr(tr, "_coarse_rank",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    one = (tr.stein_rate_os_peak(needle, hay, freqs, RATES, FS, device="cpu"),
           tr.stein_rate_os_peaks(needle, hay, freqs, RATES, FS, 3,
                                  device="cpu"),
           tr.rate_overlap_save_peaks(needle, hay, freqs, RATES, FS, 3,
                                      with_snr=True, device="cpu"))
    assert len(calls) == 2
    monkeypatch.setattr(tr, "_RATE_PARTIALS_BUDGET", 1)
    monkeypatch.setattr(tr, "_BANK_CELLS", 1)
    many = (tr.stein_rate_os_peak(needle, hay, freqs, RATES, FS,
                                  device="cpu"),
            tr.stein_rate_os_peaks(needle, hay, freqs, RATES, FS, 3,
                                   device="cpu"),
            tr.rate_overlap_save_peaks(needle, hay, freqs, RATES, FS, 3,
                                       with_snr=True, device="cpu"))
    assert len(calls) == 2 + 2 * len(RATES)
    assert one[0] == many[0]
    for a, b in zip(one[1:], many[1:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
