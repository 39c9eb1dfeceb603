"""The port's multi-emitter lattices and detection against the JAX
package on the CPU: the NMS primitives, the detection threshold, K1's
top-2 mode (e) in its plain version, and the lattice engines.

Each case feeds the same numpy inputs, made from a seed, to both
packages.  Lattice rows (freq, lag) must be identical; exact re-score
values agree within rtol 2e-5 (the same f32 filterbank rows, FFTs summed
in another order).  The JAX engines rank with their XLA twin on the
CPU, the port's with K1's f32 plain version; the kernel itself is held
to its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models import batched_stein as jbs
from caf_cookoff_tpu.models import overlap_save as jos
from caf_cookoff_tpu.ops import pallas_stein as jps
from caf_cookoff_tpu.ops import peak as jpk
from caf_cookoff_tpu.ops.splitfft import split_array
from caf_cookoff_tpu_torch.errors import EligibilityError
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import filterbank as tfb
from caf_cookoff_tpu_torch.models import overlap_save as tos
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.ops import peak as tpk
from caf_cookoff_tpu_torch.utils.convert import stein_operands_from_numpy

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0
GRID = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
COARSE = np.arange(-100.0, 100.0, 2.5, dtype=np.float32)
VALUE_RTOL = 2e-5


def _cands(pk_mod, v, f, lg):
    """A candidate triple for ``pk_mod`` (the JAX or the port's module)."""
    if pk_mod is jpk:
        return jpk.CafPeak(jnp.asarray(v, jnp.float32),
                           jnp.asarray(f, jnp.int32),
                           jnp.asarray(lg, jnp.int32))
    return tpk.CafPeak(torch.tensor(v, dtype=torch.float32),
                       torch.tensor(f, dtype=torch.int32),
                       torch.tensor(lg, dtype=torch.int32))


def _merged(v, f, lg, *args, **kw):
    """merge_peaks of both packages on the same candidates: the port's
    fields as lists, after checking they equal JAX's."""
    want = jpk.merge_peaks(_cands(jpk, v, f, lg), *args, **kw)
    got = tpk.merge_peaks(_cands(tpk, v, f, lg), *args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [x.tolist() for x in got]


def test_merge_peaks_dedups_and_ranks():
    v, f, lg = _merged([9.5, 10.0, 8.0, -np.inf], [5, 5, 20, 0],
                       [110, 100, 300, 0], 3, exclude_freq=2,
                       exclude_lag=32)
    assert v[:2] == [10.0, 8.0] and not np.isfinite(v[2])
    assert f[:2] == [5, 20] and lg[:2] == [100, 300]


def test_merge_peaks_abutting_cells():
    """One sample past the exclusion window keeps both; at its edge the
    weaker is suppressed."""
    assert _merged([10.0, 9.5], [5, 5], [100, 133], 2, exclude_freq=2,
                   exclude_lag=32)[2] == [100, 133]
    v, _, lg = _merged([10.0, 9.5], [5, 5], [100, 132], 2, exclude_freq=2,
                       exclude_lag=32)
    assert lg[0] == 100 and not np.isfinite(v[1])


def test_merge_peaks_sentinels_cannot_suppress():
    v, _, _ = _merged([-np.inf, 7.0], [0, 0], [0, 3], 2, exclude_freq=2,
                      exclude_lag=32)
    assert v[0] == 7.0


def test_merge_peaks_deterministic_tiebreak():
    """Equal values: the row-major (freq, lag) order wins, in either
    input order."""
    for f, lg in (([9, 2], [10, 500]), ([2, 9], [500, 10])):
        _, fo, lo = _merged([5.0, 5.0], f, lg, 1, 1, 1)
        assert (fo[0], lo[0]) == (2, 500)


# JAX's merge_peaks under jit: one compile per shape and static setting,
# shared by the fuzz cases.
_JAX_MERGE = jax.jit(jpk.merge_peaks, static_argnums=(1, 2, 3),
                     static_argnames=("return_indices", "lag_period"))


@pytest.mark.parametrize("seed", range(6))
def test_merge_peaks_fuzz_with_ties(seed):
    """Seeded lattices full of tied values, frequencies and lags, some
    -inf, circular or linear lags, 1-6 slots (fewer candidates than slots
    too): the port's ``num_peaks``-step loop equals the JAX package's
    scan over every candidate field for field, including the
    original-order indices; one batched call equals the per-lattice
    calls."""
    rng = np.random.default_rng(seed)
    for trial in range(16):
        c = (4, 9, 33)[trial % 3]
        num_peaks = (1, 3, 6)[int(rng.integers(0, 3))]
        v = rng.integers(0, 5, c).astype(np.float32)
        v[rng.random(c) < 0.2] = -np.inf
        f = rng.integers(0, 8, c)
        lg = rng.integers(0, 40, c)
        ef, el = ((0, 1), (2, 4), (1, 3))[seed % 3]
        period = 40 if trial % 2 else None
        want, want_i = _JAX_MERGE(_cands(jpk, v, f, lg), num_peaks, ef, el,
                                  return_indices=True, lag_period=period)
        got, got_i = tpk.merge_peaks(_cands(tpk, v, f, lg), num_peaks, ef,
                                     el, return_indices=True,
                                     lag_period=period)
        for g, w in zip((*got, got_i), (*want, want_i)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v = rng.integers(0, 5, (2, 3, 30)).astype(np.float32)
    f, lg = rng.integers(0, 8, v.shape), rng.integers(0, 40, v.shape)
    stacked = tpk.merge_peaks(_cands(tpk, v, f, lg), 3, 1, 2)
    for i in np.ndindex(2, 3):
        want = jpk.merge_peaks(_cands(jpk, v[i], f[i], lg[i]), 3, 1, 2)
        for g, w in zip(stacked, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


@pytest.mark.parametrize("period", [None, 50])
def test_find_peaks_matches_jax(period):
    rng = np.random.default_rng(3)
    surf = rng.integers(0, 9, (20, 50)).astype(np.float32)  # many ties
    want = jpk.find_peaks(surf, 6, 2, 3, lag_period=period)
    got = tpk.find_peaks(torch.from_numpy(surf), 6, 2, 3, lag_period=period)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _emitters(truths, n=1024, total=16384, seed=5):
    """(needle, capture): needle copies at (freq_hz, lag, amp) truths over
    a -80 dB noise floor."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in truths:
        end = min(lag + n, total)
        hay[lag:end] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)[:end - lag]
    return needle, hay


def _rows(fr, lg, vv):
    return [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
            if np.isfinite(float(v))]


def test_find_peaks_resolution_cell_fine_grid():
    """Auto windows on a 0.5 Hz grid keep a skirt from re-detecting: both
    packages list the two emitters of an overlap-save surface."""
    truths = ((-30.0, 200, 1.0), (42.0, 2000, 0.7))
    needle, hay = _emitters(truths, total=4096)
    ef, el = tpk.resolution_cell(needle, GRID, FS)
    assert (ef, el) == jpk.resolution_cell(needle, GRID, FS)
    want = jpk.find_peaks(np.asarray(jos.overlap_save_surface(
        needle, hay, GRID, FS)), 2, ef, el)
    got = tpk.find_peaks(tos.overlap_save_surface(needle, hay, GRID, FS,
                                                  device="cpu"), 2, ef, el)
    assert got.lag_idx.tolist() == np.asarray(want.lag_idx).tolist()
    assert got.freq_idx.tolist() == np.asarray(want.freq_idx).tolist()
    assert sorted((float(GRID[k]), int(t)) for k, t in zip(
        got.freq_idx, got.lag_idx)) == sorted((f, lag) for f, lag, _ in
                                              truths)


def test_resolution_cell_and_thresholds_match_jax():
    needle, _ = _emitters(())
    t = np.arange(4096)
    narrow = (np.exp(2j * np.pi * 0.01 * t) * np.hanning(4096)
              ).astype(np.complex64)
    for nd in (needle, narrow):
        for grid in (COARSE, GRID, np.array([5.0], np.float32)):
            assert tpk.resolution_cell(nd, grid, FS) == \
                jpk.resolution_cell(nd, grid, FS)
            assert tpk.resolve_exclusions(nd, grid, FS, 3, None) == \
                jpk.resolve_exclusions(nd, grid, FS, 3, None)
    for cells in (1, 2, 400 * 8192, 10 ** 9):
        for pfa in (1e-3, 1e-6):
            assert tpk.detection_threshold_db(cells, pfa) == \
                jpk.detection_threshold_db(cells, pfa)
    rng = np.random.default_rng(2)
    values = rng.exponential(5.0, (3, 4))
    values[0, 3] = -np.inf
    values[1, 2] = 0.0
    floor = np.array([1.0, 0.5, 2.0])
    for thresh in (None, "auto", 6.0):
        got = tpk.apply_detection_threshold(values, floor, 4096, thresh)
        want = jpk.apply_detection_threshold(values, floor, 4096, thresh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# K1 mode (e): the plain version
# ---------------------------------------------------------------------------


def _operands(needles, hays, k, d, v, windows, share_h, circular):
    """JAX-built K1 operands: lmat per (pair, band) from ``needles``
    (P*S, n), h_ext per pair (circular) or per (pair, window); returns
    (ops, b, sup, the JAX twin's per-program repeats of lmat and h_ext)."""
    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    hs_re, hs_im = map(jnp.asarray, split_array(hays))
    b = needles.shape[-1] // d
    lmat, sup = jbs._needle_operator(ns_re, ns_im, d)
    span = jps.fused_span(b, sup, v)
    if circular:
        h_ext = jbs._haystack_extension(hs_re, hs_im, v, span)
    else:
        h_ext = jbs._os_window_extensions(hs_re, hs_im, v, windows, span)
    ws1, ws2 = jps.stein_synthesis_weights(
        jnp.asarray(np.linspace(-100, 100, k).astype(np.float32)), FS, b, d)
    p = hays.shape[0]
    ln = h_ext.shape[-1]
    reps = (jnp.repeat(lmat, windows, axis=0),
            jnp.broadcast_to(h_ext.reshape(p, 1, windows, 2, ln),
                             (p, share_h, windows, 2, ln)
                             ).reshape(p * share_h * windows, 2, ln))
    return (ws1, ws2, lmat, h_ext), b, sup, reps


def _noise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (P, S, W, num_valid of the last window or None): (b+e), (d+e) with a
# window cut to 0 lags, (c+d+e).
TOP2_MODES = [(3, 1, 1, None), (2, 1, 3, 0), (2, 3, 2, 700)]


@pytest.mark.parametrize("p,s,w,last", TOP2_MODES)
def test_top2_plain_f32_matches_xla_twin(p, s, w, last):
    """The plain version with ``want_top2`` against
    ``_coarse_rank_xla(want_top2=True)`` fed per-program operands, as the
    JAX package's CPU route feeds it: f32 values within rtol 1e-4 in both
    slots, both lag slots identical."""
    n, d, k, v, sep = 512, 64, 24, 1024, 5
    rng = np.random.default_rng(p * 100 + s * 10 + w)
    needles = _noise(rng, (p * s, n))
    hays = _noise(rng, (p, n if w == 1 else w * v + n))
    ops, b, sup, reps = _operands(needles, hays, k, d, v, w, s, w == 1)
    nv = None
    if last is not None:
        nv = np.tile(np.r_[[v] * (w - 1), last], p * s).astype(np.int32)
    want = jbs._coarse_rank_xla(ops[0], ops[1], *reps, b, sup, v,
                                num_valid=None if nv is None
                                else jnp.asarray(nv),
                                want_top2=True, sep=sep)
    got = tfs.coarse_rank_plain(*stein_operands_from_numpy(*ops,
                                                           device="cpu"),
                                b, sup, v, windows=w, share_h=s,
                                num_valid=nv, want_top2=True, sep=sep)
    assert got[0].shape == (k, p * s * w)
    for slot in (1, 3):
        np.testing.assert_array_equal(got[slot].numpy(),
                                      np.asarray(want[slot]))
    for slot in (0, 2):
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-4)
    if last == 0:
        cut = got[0][:, w - 1::w]
        assert cut.eq(-1.0).all() and got[2][:, w - 1::w].eq(-1.0).all()
        assert got[1][:, w - 1::w].eq(0).all() and \
            got[3][:, w - 1::w].eq(0).all()


def _spike_operands(spikes, n=512, d=64, k=16, v=1024):
    """One program whose |R|^2 is flat over the bins and equals the
    squared spike amplitude at each spike's lag: an impulse needle
    against a capture of (lag, amplitude) spikes."""
    needle = np.zeros((1, n), np.complex64)
    needle[0, 0] = 1.0
    hay = np.zeros((1, 2 * v), np.complex64)
    for lag, amp in spikes:
        hay[0, lag] = amp
    return _operands(needle, hay, k, d, v, 1, 1, False)


def test_top2_keeps_a_pair_past_sep_across_tile_edges():
    """The stronger emitter at lag 514 (two past a 512- and 128-lag tile
    edge), its skirt at 511 and the weaker at 505, 1.5*sep from it: the
    plain version, like the JAX twin, keeps the weaker in slot 2.  JAX's
    TPU kernel (interpret mode) merges its 512-lag tiles greedily and
    loses it there — the (sep, 2*sep] band where its contract ends."""
    sep = 6
    ops, b, sup, reps = _spike_operands([(514, 3.0), (511, 2.5), (505, 2.0)])
    want = jbs._coarse_rank_xla(ops[0], ops[1], *reps, b, sup, 1024,
                                want_top2=True, sep=sep)
    got = tfs.coarse_rank_plain(*stein_operands_from_numpy(*ops,
                                                           device="cpu"),
                                b, sup, 1024, want_top2=True, sep=sep)
    assert got[1].unique().tolist() == [514]
    assert got[3].unique().tolist() == [505]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    tpu = jps.fused_stein_rank(*ops, b, sup, 1024, interpret=True,
                               want_top2=True, sep=sep)
    assert np.asarray(tpu[1]).tolist() == got[1].tolist()
    assert 505 not in np.asarray(tpu[3]).tolist()


@pytest.mark.parametrize("s,w", [(1, 1), (1, 3), (3, 2)])
def test_top2_plain_bf16_matches_pallas_kernel(s, w):
    """The plain version with the kernel's bf16 roundings against JAX's
    Pallas kernel in interpret mode with ``want_top2``, on planted pairs
    more than 2*sep apart (impulse needles and two spikes a window, the
    stronger one past the short last window's bound): identical lags in
    both slots, values within the JAX package's 2e-2."""
    p, n, d, k, v, sep = 2, 512, 64, 16, 1024, 4
    total = w * v - 300
    needles = np.zeros((p * s, n), np.complex64)
    for j in range(p * s):
        needles[j, 7 * j] = 1.0
    hays = np.zeros((p, total + n), np.complex64)
    for pair in range(p):
        for win in range(w):
            hays[pair, win * v + 101 + 13 * pair + 29 * win] = 2.0
            hays[pair, win * v + 903 + 17 * pair] = 3.0 if win else 1.0
    ops, b, sup, _ = _operands(needles, hays, k, d, v, w, s, False)
    nv = np.tile(np.clip(total - np.arange(w) * v, 0, v), p * s
                 ).astype(np.int32)
    want = jps.fused_stein_rank(*ops, b, sup, v, interpret=True, windows=w,
                                share_h=s, num_valid=jnp.asarray(nv),
                                want_top2=True, sep=sep)
    got = tfs.fused_stein_rank(*stein_operands_from_numpy(*ops,
                                                          device="cpu"),
                               b, sup, v, windows=w, share_h=s, num_valid=nv,
                               want_top2=True, sep=sep)
    for slot in (1, 3):
        np.testing.assert_array_equal(got[slot].numpy(),
                                      np.asarray(want[slot]))
    for slot in (0, 2):
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=2e-2)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _both(name, *args, **kw):
    """One lattice engine of both packages on the same inputs: the port's
    output, after checking its rows (freq, lag) equal JAX's and its
    finite values are within VALUE_RTOL."""
    mods = {"batched_stein_os_peaks": (tbs, jbs),
            "batched_stein_peaks": (tbs, jbs),
            "overlap_save_peaks": (tos, jos),
            "batched_overlap_save_peaks_local": (tos, jos)}[name]
    got = getattr(mods[0], name)(*args, device="cpu", **kw)
    want = getattr(mods[1], name)(*args, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    fin = np.isfinite(np.asarray(want[2]))
    np.testing.assert_array_equal(np.isfinite(got[2]), fin)
    np.testing.assert_allclose(got[2][fin], np.asarray(want[2])[fin],
                               rtol=VALUE_RTOL)
    if len(want) > 3:                          # snr_db
        np.testing.assert_allclose(got[3], np.asarray(want[3]), atol=1e-3)
    return got


THREE = ((-30.0, 3000, 1.0), (45.0, 9000, 0.8), (10.0, 14000, 0.6))


def test_os_peaks_matches_lattice_scan():
    """Fused long-capture lattice vs the cuFFT lattice scan, both
    packages: the three emitters row for row (windows > 1)."""
    needle, hay = _emitters(THREE)
    fr, lg, vv = _both("batched_stein_os_peaks", needle[None], hay[None],
                       GRID, FS, 4)
    fr2, lg2, vv2 = _both("batched_overlap_save_peaks_local", needle[None],
                          hay[None], GRID, FS, 4)
    truths = [(f, lag) for f, lag, _ in THREE]
    assert _rows(fr[0], lg[0], vv[0])[:3] == _rows(fr2[0], lg2[0],
                                                   vv2[0])[:3] == truths
    np.testing.assert_allclose(vv[0][:3], vv2[0][:3], rtol=VALUE_RTOL)


def test_os_peaks_same_lag_distinct_freq_pair():
    """Two emitters at one lag, far apart in frequency: the per-entry
    re-score's freq-cell restriction keeps both."""
    needle, hay = _emitters(((-20.0, 5000, 1.0), (70.0, 5000, 0.6)), seed=7)
    fr, lg, vv = _both("batched_stein_os_peaks", needle[None], hay[None],
                       GRID, FS, 3)
    assert {int(x) for x in lg[0][:2]} == {5000}


def test_os_peaks_detection_threshold():
    """Noise only: every slot masks below the auto threshold; with
    emitters, their slots pass with SNRs equal to JAX's."""
    rng = np.random.default_rng(3)
    needle = _noise(rng, 1024)
    noise = (1e-3 * _noise(rng, 16384)).astype(np.complex64)
    _, _, vv, _ = _both("batched_stein_os_peaks", needle[None], noise[None],
                        GRID, FS, 3, min_snr_db="auto", with_snr=True)
    assert not np.isfinite(vv).any()
    truths = ((-30.0, 3000, 1.0), (45.0, 9000, 0.5))
    needle, hay = _emitters(truths)
    fr, lg, vv, snr = _both("batched_stein_os_peaks", needle[None],
                            hay[None], GRID, FS, 3, min_snr_db="auto",
                            with_snr=True, capture_lens=[16000])
    assert _rows(fr[0], lg[0], vv[0])[:2] == [(f, lag) for f, lag, _ in
                                             truths]
    assert (snr[0][:2] > 20).all()


def _equal_length_pair(rng, n, f1, f2, lag2, amp2=0.7):
    nd = _noise(rng, n)
    t = np.arange(n)
    hay = (nd * np.exp(2j * np.pi * f1 * t / FS)).astype(np.complex64)
    hay = hay + amp2 * np.roll(
        (nd * np.exp(2j * np.pi * f2 * t / FS)).astype(np.complex64), lag2)
    return nd, (hay + 1e-4 * _noise(rng, n)).astype(np.complex64)


def test_equal_length_peaks_vs_surface_oracle():
    """Equal-length lattices (circular lags) of two pairs: equal to JAX's
    and to ``find_peaks`` over each pair's exact surface."""
    rng = np.random.default_rng(7)
    pairs = [_equal_length_pair(rng, 1024, -20.0, 35.0, 300),
             _equal_length_pair(rng, 1024, 12.5, -60.0, 777)]
    nds, hays = (np.stack(x) for x in zip(*pairs))
    fr, lg, vv = _both("batched_stein_peaks", nds, hays, GRID, FS, 2)
    for i, (nd, hay) in enumerate(pairs):
        surf = tfb.caf_surface(nd, hay, GRID, FS, device="cpu")
        ef, el = tpk.resolve_exclusions(nd, GRID, FS, None, None)
        pk = tpk.find_peaks(surf, 2, ef, el, lag_period=surf.shape[-1])
        assert _rows(fr[i], lg[i], vv[i]) == [
            (float(GRID[int(f)]), int(l)) for f, l in zip(pk.freq_idx,
                                                          pk.lag_idx)]
        np.testing.assert_allclose(vv[i], pk.value.numpy(),
                                   rtol=VALUE_RTOL)


def test_equal_length_num_peaks1_matches_argmax(chirp):
    n0, h0, _ = chirp(0)
    fr1, lg1, _ = tbs.batched_stein_peak(n0[None], h0[None], GRID, FS,
                                         device="cpu")
    fr, lg, _ = _both("batched_stein_peaks", n0[None], h0[None], GRID, FS,
                      1)
    assert (float(fr[0][0]), int(lg[0][0])) == (float(fr1[0]), int(lg1[0]))


def test_peaks_wide_span_raises_eligibility(chirp):
    n0, h0, _ = chirp(0)
    wide = np.arange(-6000.0, 6000.0, 10.0, dtype=np.float32)
    with pytest.raises(EligibilityError, match="band"):
        tbs.batched_stein_peaks(n0[None], h0[None], wide, FS, 2,
                                device="cpu")


def test_os_peaks_banded_grid():
    """A wide fine uniform grid routes banded ((c+d+e) programs): equal
    to JAX's, to both packages' lattice scans and to the truths."""
    n, total = 2048, 16384
    rng = np.random.default_rng(5)
    nd = _noise(rng, n)
    hay = (1e-4 * _noise(rng, total)).astype(np.complex64)
    freqs = np.linspace(-500, 500, 256, endpoint=False).astype(np.float32)
    t = np.arange(n)
    truths = []
    for f_idx, lag, amp in ((30, 3000, 1.0), (181, 9000, 0.7),
                            (97, 12000, 0.5)):
        f = float(freqs[f_idx])
        hay[lag:lag + n] += (amp * nd * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
        truths.append((f, lag))
    fr, lg, vv = _both("batched_stein_os_peaks", nd[None], hay[None], freqs,
                       FS, 4)
    fr2, lg2, vv2 = _both("batched_overlap_save_peaks_local", nd[None],
                          hay[None], freqs, FS, 4)
    assert _rows(fr[0], lg[0], vv[0])[:3] == _rows(fr2[0], lg2[0],
                                                   vv2[0])[:3] == truths
    np.testing.assert_allclose(vv[0][:3], vv2[0][:3], rtol=VALUE_RTOL)


def test_equal_length_wrap_skirt_cannot_displace_real_emitter():
    """Circular-lag NMS: an oversampled needle's skirt at lag m-1 of a
    lag-0 peak does not take the slot of a separated weaker emitter."""
    from scipy import signal as sp_signal

    n = 2048
    rng = np.random.default_rng(13)
    taps = sp_signal.firwin(127, 1 / 8)
    nd = sp_signal.filtfilt(taps, [1.0], rng.standard_normal(n)
                            + 1j * rng.standard_normal(n)
                            ).astype(np.complex64)
    t = np.arange(n)
    hay = (nd * np.exp(2j * np.pi * 30.0 * t / FS)).astype(np.complex64)
    hay = hay + 0.6 * np.roll(
        (nd * np.exp(2j * np.pi * -55.0 * t / FS)).astype(np.complex64), 400)
    hay = (hay + 1e-4 * _noise(rng, n)).astype(np.complex64)
    fr, lg, vv = _both("batched_stein_peaks", nd[None], hay[None], GRID, FS,
                       2)
    assert sorted(l for _, l in _rows(fr[0], lg[0], vv[0])) == [0, 400]


def test_rescore_guards_match_jax():
    for args in ((1024, 6, 2048), (1024, 6, 1024), (4096, 3, 36864),
                 (2048, 70, 16384), (128, 2, 130)):
        assert tbs._rescore_guards(*args) == jbs._rescore_guards(*args)


def test_stein_model_floor_matches_jax():
    rng = np.random.default_rng(4)
    needles, hays = _noise(rng, (3, 64)), _noise(rng, (3, 300))
    for lens in (None, [300, 200, 17], 250):
        np.testing.assert_array_equal(
            tbs._stein_model_floor(needles, hays, valid_len=lens),
            jbs._stein_model_floor(needles, hays, valid_len=lens))


def test_overlap_save_peaks_three_emitters():
    needle, hay = _emitters(THREE)
    fr, lg, vv = _both("overlap_save_peaks", needle, hay, COARSE, FS, 4)
    assert _rows(fr, lg, vv)[:3] == [(f, lag) for f, lag, _ in THREE]
    finite = [v for v in vv if np.isfinite(v)]
    assert finite == sorted(finite, reverse=True)


def test_overlap_save_peaks_abutting_and_block_edge():
    """Two same-frequency emitters one lag past the exclusion window
    both survive; an emitter on a block edge is reported once; with the
    auto threshold the SNRs equal JAX's."""
    from caf_cookoff_tpu_torch.models.overlap_save import plan_blocks

    needle, _ = _emitters(())
    ef, el = tpk.resolution_cell(needle, COARSE, FS)
    _, v, _ = plan_blocks(1024, 15000)
    lag2 = 3000 + el + 1
    needle, hay = _emitters(((-30.0, 3000, 1.0), (-30.0, lag2, 0.7),
                             (45.0, v - 1, 0.8)))
    fr, lg, vv, _ = _both("overlap_save_peaks", needle, hay, COARSE, FS, 5,
                          exclude_freq=ef, exclude_lag=el,
                          min_snr_db="auto", with_snr=True)
    got = _rows(fr, lg, vv)
    assert got[0] == (-30.0, 3000)
    assert (-30.0, lag2) in got and (45.0, v - 1) in got
    near = [(f, l) for f, l in got if f == 45.0 and 0 < abs(l - v + 1) < 64]
    assert not near


def test_batched_local_lattices():
    rng = np.random.default_rng(5)
    pairs, n, total = 3, 1024, 16384
    needles = _noise(rng, (pairs, n))
    hays = (1e-4 * _noise(rng, (pairs, total))).astype(np.complex64)
    t = np.arange(n)
    truths = {}
    for b in range(pairs):
        truths[b] = [(-30.0 + 5 * b, 3000 + 500 * b), (40.0, 9000 + 700 * b)]
        for amp, (f, lag) in zip((1.0, 0.7), truths[b]):
            hays[b, lag:lag + n] += (amp * needles[b] * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
    fr, lg, vv = _both("batched_overlap_save_peaks_local", needles, hays,
                       COARSE, FS, 3)
    assert fr.shape == (pairs, 3)
    for b in range(pairs):
        assert _rows(fr[b], lg[b], vv[b])[:2] == truths[b]


def test_num_peaks_one_is_a_lattice():
    """``num_peaks=1`` through the scan is a 1-slot lattice whose row is
    the single-peak scan's answer."""
    needle, hay = _emitters(THREE[:1])
    fr, lg, vv = _both("batched_overlap_save_peaks_local", needle[None],
                       hay[None], COARSE, FS, 1)
    assert fr.shape == (1, 1)
    single = tos.overlap_save_peak(needle, hay, COARSE, FS, device="cpu")
    assert (float(fr[0, 0]), int(lg[0, 0])) == single[:2]
