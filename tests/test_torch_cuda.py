"""The port on a CUDA card: the fused Stein kernel (K1) and the fused
filterbank kernels (K2 peak rows, K3 surface) against their plain
versions, the main paths through them (``StreamingCAF`` among them), and
the bench harness.

Every test here needs a card and skips without one.  The file imports
neither JAX nor the conftest's fixtures, so on a machine with a card and
no JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import pathlib

import numpy as np
import pytest
import torch

from caf_cookoff_tpu_torch import FreqGrid, VmemBudgetError, caf_peak
from caf_cookoff_tpu_torch.models.batched_stein import (_haystack_extension,
                                                        _needle_operator)
from caf_cookoff_tpu_torch.ops import fused_stein as fs
from caf_cookoff_tpu_torch.ops import pallas_caf as pc
from caf_cookoff_tpu_torch.utils.bench import run_benchmarks
from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
from caf_cookoff_tpu_torch.utils.io import load_c64

pytestmark = pytest.mark.cuda

FS = 48_000.0
LAG_SHARE = 0.99   # least share of bins whose lag equals the plain argmax
# K2/K3 vs plain versions: two f32 FFT algorithms (the kernel's
# register-radix passes, cuFFT) that differ in the order of their sums.
FB_RTOL = 1e-5
FB_SURF_TOL = 1e-5
DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _operands(needles, hays, freqs, m, d):
    """Kernel operands on the card from (P, n) complex numpy pairs."""
    n = torch.from_numpy(needles).cuda()
    h = torch.from_numpy(hays).cuda()
    b = needles.shape[-1] // d
    lmat, sup = _needle_operator(n.real, n.imag, d)
    h_ext = _haystack_extension(h.real, h.imag, m, fs.fused_span(b, sup, m))
    ws1, ws2 = fs.stein_synthesis_weights(torch.from_numpy(freqs).cuda(),
                                          FS, b, d)
    return (ws1, ws2, lmat, h_ext), b, sup


def _assert_bound(got, ops, b, sup, m, sep=None, **modes):
    """K1's answer held to ``rank_bound_check``: each value within its
    error bound of the f64 stage B on the plain version's G, each lag's
    f64 value within the bounds of the bin's f64 max (both slots with
    ``sep``)."""
    torch.cuda.synchronize()
    r = fs.rank_bound_check(got, *ops, b, sup, m, sep=sep, **modes)
    assert r["ok"], r


def _pairs(rng, p, n, hay_len=None):
    shape = (p, hay_len or n)
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return needles, hays


@pytest.mark.parametrize("p,n,d,k,m", [(2, 1024, 32, 37, 2048),
                                       (1, 4096, 64, 400, 8192),
                                       (3, 128, 32, 9, 256),
                                       (1, 1024, 8, 70, 2100),
                                       (2, 1024, 128, 65, 2048)])
def test_kernel_matches_plain_on_card(card, p, n, d, k, m):
    """Kernel vs the f64 stage B on the plain version's G: values and
    lags within the error bound (2B = 64, 128, 8, 256, 16)."""
    needles, hays = _pairs(np.random.default_rng(3), p, n)
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    ops, b, sup = _operands(needles, hays, freqs, m, d)
    before = fs.LAUNCHES
    kv, ki = fs.fused_stein_rank(*ops, b, sup, m)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    assert kv.shape == ki.shape == (k, p)
    assert int(ki.max()) < m
    _assert_bound((kv, ki), ops, b, sup, m)


def test_kernel_tie_break_on_card(card):
    """Two bit-identical needle copies at lags 100 and 3172 (different
    lag tiles and blocks) tie exactly; the lowest lag wins."""
    rng = np.random.default_rng(11)
    n, d, k, m = 512, 64, 17, 4096
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros((1, 3172 + n), np.complex64)
    hay[0, 100:100 + n] = needle
    hay[0, 3172:3172 + n] = needle
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    ops, b, sup = _operands(needle[None], hay, freqs, m, d)
    _, ki = fs.fused_stein_rank(*ops, b, sup, m)
    assert int(ki[k // 2, 0]) == 100


def test_kernel_rejects_bad_operands_on_card(card):
    needles, hays = _pairs(np.random.default_rng(4), 1, 256)
    freqs = np.linspace(-50, 50, 8).astype(np.float32)
    ops, b, sup = _operands(needles, hays, freqs, 512, 32)
    with pytest.raises(TypeError):
        fs.fused_stein_rank(ops[0].to(torch.int32), *ops[1:], b, sup, 512)
    with pytest.raises(ValueError, match="several devices"):
        fs.fused_stein_rank(ops[0].cpu(), *ops[1:], b, sup, 512)


GOLDEN = [
    (0, (-100.0, 100.0, 0.25), 69.25, 202),
    (1, (-50.0, 50.0, 1.0), 36.0, 78),
    (2, (30.0, 35.0, 0.05), 32.15, 169),
    (3, (-100.0, 100.0, 0.25), -76.25, 151),
    (4, (80.0, 100.0, 0.1), 82.9, 70),
    (5, (-100.0, 100.0, 0.25), -92.75, 177),
    (6, (-100.0, 100.0, 0.25), -49.75, 15),
    (7, (-100.0, 100.0, 0.25), 68.25, 84),
    (8, (-100.0, 100.0, 0.25), -46.25, 80),
    (9, (-100.0, 100.0, 0.5), 61.5, 176),
]


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_main_path_goldens_on_card(card, idx, grid, want_freq, want_lag):
    """``caf_peak(backend="stein")`` on the card answers every golden
    exactly and goes through the kernel; the cuFFT filterbank agrees."""
    needle_path, hay_path = ensure_fixtures(DATA)[idx]
    needle = load_c64(needle_path)
    hay = load_c64(hay_path, count=len(needle))
    freqs = FreqGrid(*grid).frequencies(np.float32)
    before = fs.LAUNCHES
    freq, lag, value = caf_peak(needle, hay, freqs, FS, backend="stein",
                                device="cuda")
    assert fs.LAUNCHES == before + 1
    assert freq == pytest.approx(want_freq, abs=1e-4)
    assert lag == want_lag
    fb = caf_peak(needle, hay, freqs, FS, backend="xla", device="cuda")
    assert fb[:2] == (freq, lag)
    # Same exact re-score rows: f32 cuFFT, batched differently.
    assert fb[2] == pytest.approx(value, rel=1e-4)


def _signal_pair(rng, n, lag):
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (np.roll(needle, lag) + 0.1 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
           ).astype(np.complex64)
    return torch.from_numpy(needle).cuda(), torch.from_numpy(hay).cuda()


# K x M capped at 400 x 32768 so the plain (K, M) rows fit comfortably;
# M = 2, 8, 16: rows under 32 points, one thread a bin.
FB_SHAPES = [(m, k) for m in (2, 8, 16, 1024, 8192, 16384, 32768, 131072)
             for k in (1, 8, 400) if k * m <= 400 * 32768]


@pytest.mark.parametrize("m,k", FB_SHAPES)
def test_filterbank_kernels_match_plain_on_card(card, m, k):
    """K2: values within FB_RTOL, the plain value at the kernel's lag
    within FB_RTOL of the bin maximum, lags the plain argmax in all but
    near-tied bins; K3: max abs error within FB_SURF_TOL x max.  Each
    shape's cluster size is the wrapper's (1 to 16 blocks a bin; under
    32 points one thread a bin)."""
    needle, hay = _signal_pair(np.random.default_rng(m + k), m // 2, 37)
    freqs = torch.linspace(-300.0, 300.0, k, device="cuda")
    before = (pc.PEAK_LAUNCHES, pc.SURFACE_LAUNCHES)
    kv, ki = pc.pallas_peak_rows(needle, hay, freqs, FS, m)
    ks = pc.pallas_surface(needle, hay, freqs, FS, m)
    torch.cuda.synchronize()
    assert (pc.PEAK_LAUNCHES, pc.SURFACE_LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)
    rows = pc._mag2(pc._rows_plain(needle, hay, freqs, FS, m))
    pv, pi = rows.max(-1)
    assert kv.shape == ki.shape == (k,)
    torch.testing.assert_close(kv, pv, rtol=FB_RTOL, atol=0)
    at = torch.gather(rows, 1, ki.long()[:, None])[:, 0]
    assert bool((at >= (1 - FB_RTOL) * pv).all())
    assert (ki == pi.to(torch.int32)).float().mean().item() >= LAG_SHARE
    del rows
    ps = pc.caf_surface_plain(needle, hay, freqs, FS, m)
    assert ks.shape == (k, m)
    assert (ks - ps).abs().max().item() <= FB_SURF_TOL * ps.max().item()


@pytest.mark.parametrize("m", [2, 8, 16])
def test_filterbank_short_rows_tie_on_card(card, m):
    """Rows under 32 points, one thread a bin (70 bins: two blocks): the
    all-zero input ties every lag of every bin, and lag 0 wins."""
    zero = torch.zeros(m // 2, dtype=torch.complex64, device="cuda")
    freqs = torch.linspace(-100.0, 100.0, 70, device="cuda")
    vals, lags = pc.pallas_peak_rows(zero, zero, freqs, FS, m)
    assert lags.tolist() == [0] * 70
    assert vals.tolist() == [0.0] * 70


@pytest.mark.parametrize("m,k", [(2048, 17), (16384, 8), (65536, 2),
                                 (131072, 1)])
def test_filterbank_tie_break_on_card(card, m, k):
    """An FFT gives no bit-identical values at two different lags of
    nonzero data, so the exact tie is the all-zero input: every lag of
    every bin ties and the lowest lag, 0, wins, also when a cluster of
    2, 8 or 16 blocks splits the bin (each block's own lowest lag is
    another).  Two needle copies at lags that different blocks hold give
    a near-tie: the kernel's lag is one of them, within FB_RTOL of the
    plain maximum."""
    zero = torch.zeros(m // 2, dtype=torch.complex64, device="cuda")
    freqs = 12.5 * (torch.arange(k, device="cuda") - k // 2)   # 0 Hz: k // 2
    _, lags = pc.pallas_peak_rows(zero, zero, freqs, FS, m)
    assert lags.tolist() == [0] * k
    c = pc.cluster_size(m)
    # Block b of a cluster holds the lags t + L j, t in [b L/C, (b+1) L/C).
    lo, hi = 100, 100 + (m // c + m // c // c if c > 1 else m // 4)
    rng = np.random.default_rng(11)
    n = min(512, m // 8)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(m, np.complex64)
    hay[lo:lo + n] = needle
    hay[hi:hi + n] = needle
    nt, ht = torch.from_numpy(needle).cuda(), torch.from_numpy(hay).cuda()
    vals, lags = pc.pallas_peak_rows(nt, ht, freqs, FS, m)
    rows = pc._mag2(pc._rows_plain(nt, ht, freqs, FS, m))
    mid = k // 2
    assert int(lags[mid]) in (lo, hi)
    assert float(rows[mid, lags[mid]]) >= (1 - FB_RTOL) * float(
        rows[mid].max())


def test_filterbank_refuses_rows_past_shared_memory_on_card(card):
    """A 16384-sample needle (M = 32768, a cluster of 4 blocks a bin)
    runs and holds to the plain version; the card refuses only past
    MAX_FFT_LEN = 131072 points."""
    needle, hay = _signal_pair(np.random.default_rng(5), 16384, 777)
    freqs = torch.linspace(-50.0, 50.0, 9, device="cuda")
    kv, ki = pc.pallas_peak_rows(needle, hay, freqs, FS, 32768)
    pv, pi = pc.caf_peak_rows_plain(needle, hay, freqs, FS, 32768)
    torch.testing.assert_close(kv, pv, rtol=FB_RTOL, atol=0)
    assert torch.equal(ki, pi)
    big = torch.ones(131072, dtype=torch.complex64, device="cuda")
    with pytest.raises(VmemBudgetError, match="131072"):
        pc.pallas_peak_rows(big, big, [0.0], FS, 262144)
    with pytest.raises(VmemBudgetError, match="shared memory"):
        caf_peak(big, big, [0.0, 1.0], FS, backend="pallas", device="cuda")


@pytest.mark.parametrize("backend", ["pallas", "pallas-bf16",
                                     "pallas-refine"])
def test_long_needle_pallas_backends_on_card(card, backend):
    """``caf_peak`` / ``caf_surface`` with the pallas backends at a
    16384-sample needle (M = 32768) agree with ``backend="xla"``: the
    same (freq, lag), M^2 times its value, and the surface within the
    JAX package's bound (rtol 1e-3 + atol 1e-4 x max)."""
    rng = np.random.default_rng(8)
    n = 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (np.roll(needle, 4321) * np.exp(2j * np.pi * 37.0 * np.arange(n)
                                          / FS)).astype(np.complex64)
    freqs = np.arange(-100.0, 100.0, 1.0, dtype=np.float32)
    want = caf_peak(needle, hay, freqs, FS, backend="xla", device="cuda")
    got = caf_peak(needle, hay, freqs, FS, backend=backend, device="cuda")
    assert got[:2] == want[:2] == (37.0, 4321)
    assert got[2] == pytest.approx(want[2] * 32768.0 ** 2, rel=1e-4)
    if backend == "pallas":
        from caf_cookoff_tpu_torch import caf_surface

        s = caf_surface(needle, hay, freqs, FS, backend="pallas",
                        device="cuda")
        x = caf_surface(needle, hay, freqs, FS, backend="xla", device="cuda")
        assert s.shape == x.shape == (200, 32768)
        assert int(((s - x).abs() > 1e-3 * x.abs() + 1e-4 * x.max()).sum()
                   ) == 0


def test_filterbank_occupancy_on_card(card):
    """Every (M, C) the wrapper launches, and the one-block and 16-block
    splits where they apply, fits the card: at least one block a SM, and
    clusters the card can hold."""
    import ctypes

    from caf_cookoff_tpu_torch.ops import _build

    lib = _build.load_library()
    for m in (2, 16, 32, 1024, 8192, 16384, 32768, 131072):
        takes = {c for c in (1, 2, 4, 8, 16) if 32 <= m // c <= 8192} or {1}
        for c in sorted({1, pc.cluster_size(m), 16} & takes):
            for surface in (0, 1):
                blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
                assert lib.caf_filterbank_occupancy(
                    surface, m, c, ctypes.byref(blocks),
                    ctypes.byref(clusters)) == 0
                assert blocks.value >= 1
                assert c == 1 or clusters.value >= 1


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_pallas_refine_goldens_on_card(card, idx, grid, want_freq, want_lag):
    """``caf_peak(backend="pallas-refine")`` answers every golden
    exactly with two K2 launches, at M^2 times the cuFFT filterbank's
    value."""
    needle_path, hay_path = ensure_fixtures(DATA)[idx]
    needle = load_c64(needle_path)
    hay = load_c64(hay_path, count=len(needle))
    freqs = FreqGrid(*grid).frequencies(np.float32)
    before = pc.PEAK_LAUNCHES
    freq, lag, value = caf_peak(needle, hay, freqs, FS,
                                backend="pallas-refine", device="cuda")
    assert pc.PEAK_LAUNCHES == before + 2
    assert freq == pytest.approx(want_freq, abs=1e-4)
    assert lag == want_lag
    fb = caf_peak(needle, hay, freqs, FS, backend="xla", device="cuda")
    assert value == pytest.approx(fb[2] * 8192.0 ** 2, rel=1e-4)


def test_run_benchmarks_on_card(card):
    rows = run_benchmarks(backends=("xla", "pallas-refine", "stein"),
                          data_dir=str(DATA), rounds=2, iters=5)
    assert [r["strategy"] for r in rows] == ["xla+cuda", "pallas-refine+cuda",
                                             "stein+cuda"]
    for row in rows:
        assert "error" not in row, row
        assert row["golden"] == "exact"
        assert row["ms"] > 0
        assert row["device"] == torch.cuda.get_device_name(0)


def _modes_operands(rng, p, s, w, n, d, k, v):
    """Random operands of the kernel's composed modes on the card: lmat
    per (pair, band), h_ext per (pair, window), a per-program lag bound
    that cuts the last window short."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    def plane(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    b = n // d
    lmat, sup = _needle_operator(plane((p * s, n)), plane((p * s, n)), d)
    total = w * v - 300
    h = plane((p, total + n)), plane((p, total + n))
    h_ext = _os_window_extensions(*h, v, w, fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-100.0, 100.0, k, device="cuda"), FS, b, d)
    per_w = np.clip(total - np.arange(w) * v, 0, v)
    num_valid = torch.as_tensor(np.tile(per_w, p * s), dtype=torch.int32,
                                device="cuda")
    return (ws1, ws2, lmat, h_ext), b, sup, num_valid


@pytest.mark.parametrize("s,w", [(3, 1), (1, 3), (3, 2)])
def test_kernel_modes_match_plain_on_card(card, s, w):
    """K1 in modes (c) share_h, (d) windows + num_valid and (c+d), with
    the plain version's index maps, within the error bound."""
    p, n, d, k, v = 2, 512, 64, 40, 1024
    ops, b, sup, nv = _modes_operands(np.random.default_rng(s * 10 + w), p,
                                      s, w, n, d, k, v)
    modes = dict(windows=w, share_h=s,
                 num_valid=nv if w > 1 else None)
    before = fs.LAUNCHES
    kv, ki = fs.fused_stein_rank(*ops, b, sup, v, **modes)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    assert kv.shape == ki.shape == (k, p * s * w)
    _assert_bound((kv, ki), ops, b, sup, v, **modes)
    if w > 1:
        bound = nv.view(-1)[None, :].expand(k, -1)
        assert bool((ki < bound).all())


def test_kernel_composed_planted_lags_on_card(card):
    """(c+d) on planted structure (one impulse needle per (pair, band),
    two spikes per (pair, window), the stronger one past the short last
    window's bound): every program's lag is isolated, so kernel and
    plain version agree on every lag exactly; values within the bound."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    p, s, w, n, d, k, v = 2, 3, 2, 512, 64, 16, 1024
    total = w * v - 300
    needles = np.zeros((p * s, n), np.complex64)
    for j in range(p * s):
        needles[j, 7 * j] = 1.0
    hays = np.zeros((p, total + n), np.complex64)
    for pair in range(p):
        for win in range(w):
            hays[pair, win * v + 101 + 13 * pair + 29 * win] = 2.0
            hays[pair, win * v + 903 + 17 * pair] = 3.0 if win else 1.0
    nt, ht = torch.from_numpy(needles).cuda(), torch.from_numpy(hays).cuda()
    b = n // d
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, v, w,
                                  fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-100.0, 100.0, k, device="cuda"), FS, b, d)
    nv = torch.as_tensor(np.tile(np.clip(total - np.arange(w) * v, 0, v),
                                 p * s), dtype=torch.int32, device="cuda")
    modes = dict(windows=w, share_h=s, num_valid=nv)
    kv, ki = fs.fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, v, **modes)
    pv, pi = fs.coarse_rank_plain(ws1, ws2, lmat, h_ext, b, sup, v,
                                  emulate_bf16=True, **modes)
    torch.testing.assert_close(ki, pi, rtol=0, atol=0)
    _assert_bound((kv, ki), (ws1, ws2, lmat, h_ext), b, sup, v, **modes)


def test_kernel_zero_window_on_card(card):
    """A program whose lag bound is 0 reads -1.0 at every lag: value
    -1.0 at lag 0 in every bin, as in the TPU kernel."""
    ops, b, sup, _ = _modes_operands(np.random.default_rng(5), 1, 1, 3,
                                     256, 32, 9, 512)
    nv = torch.tensor([512, 0, 100], dtype=torch.int32, device="cuda")
    kv, ki = fs.fused_stein_rank(*ops, b, sup, 512, windows=3,
                                 num_valid=nv)
    assert kv[:, 1].tolist() == [-1.0] * 9
    assert ki[:, 1].tolist() == [0] * 9
    assert bool((kv[:, [0, 2]] > 0).all()) and int(ki[:, 2].max()) < 100


def test_kernel_programs_past_one_launch_on_card(card):
    """70000 programs (share_h 35000 x windows 2) run in two launches of
    grid z; programs on both sides of the 65535 cut are within the
    bound of the plain version fed each program's own operands."""
    rng = np.random.default_rng(9)
    n, d, k, v, s, w = 128, 32, 9, 256, 35_000, 2
    b = n // d

    def plane(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    lmat, sup = _needle_operator(plane((s, n)), plane((s, n)), d)
    h_ext = _haystack_extension(plane((w, n)), plane((w, n)), v,
                                fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-50.0, 50.0, k, device="cuda"), FS, b, d)
    kv, ki = fs.fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, v,
                                 windows=w, share_h=s)
    assert kv.shape == (k, s * w)
    progs = [0, 1, 65_533, 65_534, 65_535, 65_536, 69_999]
    for i in progs:
        _assert_bound((kv[:, i:i + 1], ki[:, i:i + 1]),
                      (ws1, ws2, lmat[i // w][None], h_ext[i % w][None]),
                      b, sup, v)


@pytest.mark.parametrize("sms", [1, 200, 100_000])
def test_bin_splits_do_not_change_answers_on_card(card, monkeypatch, sms):
    """The wrapper splits the bins over blocks when programs x lag tiles
    leave SMs idle (one block a split, 7 splits of 64 bins at most here):
    every split count gives the same values and lags, bit for bit, in
    both modes, since each bin's sums are the same."""
    needles, hays = _pairs(np.random.default_rng(12), 1, 2048)
    freqs = np.linspace(-100, 100, 400).astype(np.float32)
    ops, b, sup = _operands(needles, hays, freqs, 4096, 32)
    want = [fs.fused_stein_rank(*ops, b, sup, 4096),
            fs.fused_stein_rank(*ops, b, sup, 4096, want_top2=True, sep=5)]
    monkeypatch.setattr(fs, "_sm_count", lambda dev: sms)
    got = [fs.fused_stein_rank(*ops, b, sup, 4096),
           fs.fused_stein_rank(*ops, b, sup, 4096, want_top2=True, sep=5)]
    for g, w in zip(got, want):
        for a, z in zip(g, w):
            assert torch.equal(a, z)
    _assert_bound(got[1], ops, b, sup, 4096, 5)


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_batched_engines_goldens_on_card(card, idx, grid, want_freq,
                                         want_lag):
    """Each golden through ``batched_stein_peak`` (truncated pair) and
    ``batched_stein_os_peak`` (the whole capture file), each one K1
    launch: the golden (freq, lag)."""
    from caf_cookoff_tpu_torch import (batched_stein_os_peak,
                                       batched_stein_peak)

    needle_path, hay_path = ensure_fixtures(DATA)[idx]
    needle = load_c64(needle_path)
    full = load_c64(hay_path)
    freqs = FreqGrid(*grid).frequencies(np.float32)
    for fn, hay in ((batched_stein_peak, full[:len(needle)]),
                    (batched_stein_os_peak, full)):
        before = fs.LAUNCHES
        fr, lg, val = fn(needle[None], hay[None], freqs, FS, device="cuda")
        assert fs.LAUNCHES == before + 1
        assert float(fr[0]) == pytest.approx(want_freq, abs=1e-4)
        assert int(lg[0]) == want_lag and float(val[0]) > 0


def test_batched_engines_match_single_pair_on_card(card):
    """Five goldens as one batch on one grid: the batch answers equal
    ``stein_caf_peak`` pair by pair, and the windowed engine's banded
    route (a +-2000 Hz grid) recovers an emitter in an outer band."""
    from caf_cookoff_tpu_torch import (batched_stein_os_peak,
                                       batched_stein_peak, stein_caf_peak)

    grid = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    pairs = [ensure_fixtures(DATA)[i] for i in (0, 2, 4, 6, 9)]
    needles = np.stack([load_c64(p[0]) for p in pairs])
    hays = np.stack([load_c64(p[1], count=needles.shape[1]) for p in pairs])
    fr, lg, _ = batched_stein_peak(needles, hays, grid, FS, device="cuda")
    for i in range(len(pairs)):
        want = stein_caf_peak(needles[i], hays[i], grid, FS, device="cuda")
        assert (float(fr[i]), int(lg[i])) == want[:2]
    rng = np.random.default_rng(33)
    n, total, lag, f_true = 1024, 10240, 6100, -1650.0
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-3 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    wide = np.arange(-2000.0, 2000.0, 50.0, dtype=np.float32)
    before = fs.LAUNCHES
    fr, lg, _ = batched_stein_os_peak(needle[None], hay[None], wide, FS,
                                      device="cuda")
    assert fs.LAUNCHES == before + 1
    assert (float(fr[0]), int(lg[0])) == (f_true, lag)


# ---------------------------------------------------------------------------
# K1 mode (e): want_top2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sep", [0, 3, 200])
def test_top2_matches_plain_on_card(card, sep):
    """Mode (b+e) on random operands (two pairs, K = 37, M = 2048): both
    slots within the error bound, one launch."""
    needles, hays = _pairs(np.random.default_rng(7), 2, 1024)
    freqs = np.linspace(-100, 100, 37).astype(np.float32)
    ops, b, sup = _operands(needles, hays, freqs, 2048, 32)
    before = fs.LAUNCHES
    got = fs.fused_stein_rank(*ops, b, sup, 2048, want_top2=True, sep=sep)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    assert [tuple(t.shape) for t in got] == [(37, 2)] * 4
    _assert_bound(got, ops, b, sup, 2048, sep)
    assert bool(((got[3] - got[1]).abs() > sep).all())


@pytest.mark.parametrize("s,w", [(3, 1), (1, 3), (3, 2)])
def test_top2_modes_match_plain_on_card(card, s, w):
    """Modes (c+e), (d+e) with the last window cut short, (c+d+e)."""
    p, n, d, k, v = 2, 512, 64, 40, 1024
    ops, b, sup, nv = _modes_operands(np.random.default_rng(s * 7 + w), p,
                                      s, w, n, d, k, v)
    modes = dict(windows=w, share_h=s, num_valid=nv if w > 1 else None)
    got = fs.fused_stein_rank(*ops, b, sup, v, want_top2=True, sep=5,
                              **modes)
    _assert_bound(got, ops, b, sup, v, 5, **modes)


def _spike_operands(spikes, k=16, n=512, d=64, v=1024):
    """One program whose |R|^2 is flat over the bins and the squared
    spike amplitude at each spike's lag: an impulse needle against a
    capture of (lag, amplitude) spikes (linear window slices)."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    needle = torch.zeros(1, n, dtype=torch.complex64, device="cuda")
    needle[0, 0] = 1.0
    hay = torch.zeros(1, 2 * v, dtype=torch.complex64, device="cuda")
    for lag, amp in spikes:
        hay[0, lag] = amp
    b = n // d
    lmat, sup = _needle_operator(needle.real, needle.imag, d)
    h_ext = _os_window_extensions(hay.real, hay.imag, v, 1,
                                  fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-100.0, 100.0, k, device="cuda"), FS, b, d)
    return (ws1, ws2, lmat, h_ext), b, sup


@pytest.mark.parametrize("strong,skirt,weak", [
    (514, 511, 505),      # across a 512- (and 128-) lag tile edge
    (645, 639, 635),      # across a 128-lag tile edge only
    (505, 508, 514)])     # the weaker after the stronger
def test_top2_keeps_pairs_past_sep_across_tile_edges_on_card(
        card, strong, skirt, weak):
    """A same-bin pair 1.5*sep apart with the stronger's skirt across the
    tile edge, where the TPU kernel's greedy tile merge drops the
    weaker: the kernel keeps it in slot 2, in every bin."""
    sep = 6
    ops, b, sup = _spike_operands([(strong, 3.0), (skirt, 2.5), (weak, 2.0)])
    got = fs.fused_stein_rank(*ops, b, sup, 1024, want_top2=True, sep=sep)
    assert got[1].unique().tolist() == [strong]
    assert got[3].unique().tolist() == [weak]
    _assert_bound(got, ops, b, sup, 1024, sep)


@pytest.mark.parametrize("n,d,strong,tied,partner,sep,span", [
    (128, 32, 1000, 1310, 5000, 300, 100.0),
    (1024, 16, 4000, 2890, 1000, 1100, 10.0),
    (1024, 16, 4000, 2890, 7000, 1100, 10.0)])
def test_top2_tie_across_a_recomputed_tile_on_card(card, n, d, strong, tied,
                                                    partner, sep, span):
    """Bit-identical needle copies at lags ``tied`` and ``partner``
    outside the window of a stronger copy (``sep``): ``tied`` lies in the
    tile that straddles the window's edge, whose lags the kernel
    recomputes, the partner in a tile taken from the tile pass.  They
    tie exactly, so the lower lag is slot 2 in every bin — only if the
    recompute is the tile pass's arithmetic bit for bit and ties keep
    the lower lag.  At 2B = 128 (bins within the needle's mainlobe) a
    recompute summed otherwise loses one of the two partners' ties."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    rng = np.random.default_rng(21)
    k, v = 64, 8192
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(v + n, np.complex64)
    for lag, amp in ((strong, 2.0), (tied, 1.0), (partner, 1.0)):
        hay[lag:lag + n] = amp * needle
    nt = torch.from_numpy(needle).cuda()[None]
    ht = torch.from_numpy(hay).cuda()[None]
    b = n // d
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, v, 1,
                                  fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-span, span, k, device="cuda"), FS, b, d)
    ops = (ws1, ws2, lmat, h_ext)
    got = fs.fused_stein_rank(*ops, b, sup, v, want_top2=True, sep=sep)
    assert got[1].unique().tolist() == [strong]
    assert got[3].unique().tolist() == [min(tied, partner)]
    _assert_bound(got, ops, b, sup, v, sep)


def test_top2_sentinels_on_card(card):
    """A program with lag bound 0 reads (-1.0, 0) in both slots; a sep
    that covers every lag leaves slot 2 at (-1.0, 0) everywhere."""
    ops, b, sup, _ = _modes_operands(np.random.default_rng(5), 1, 1, 3,
                                     256, 32, 9, 512)
    nv = torch.tensor([512, 0, 100], dtype=torch.int32, device="cuda")
    got = fs.fused_stein_rank(*ops, b, sup, 512, windows=3, num_valid=nv,
                              want_top2=True, sep=4)
    for slot, want in ((0, -1.0), (1, 0), (2, -1.0), (3, 0)):
        assert got[slot][:, 1].tolist() == [want] * 9
    assert int(got[3][:, 2].max()) < 100
    _assert_bound(got, ops, b, sup, 512, 4, windows=3, num_valid=nv)
    for sep in (512, 10 ** 6):
        got = fs.fused_stein_rank(*ops, b, sup, 512, windows=3,
                                  num_valid=nv, want_top2=True, sep=sep)
        assert got[2].eq(-1.0).all() and got[3].eq(0).all()
        _assert_bound(got, ops, b, sup, 512, sep, windows=3, num_valid=nv)


def test_top2_programs_past_one_launch_on_card(card):
    """70000 programs: the top-2 reduce and recompute index programs
    globally; both sides of the 65535 cut are within the bound."""
    rng = np.random.default_rng(9)
    n, d, k, v, s, w = 128, 32, 9, 256, 35_000, 2
    b = n // d

    def plane(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    lmat, sup = _needle_operator(plane((s, n)), plane((s, n)), d)
    h_ext = _haystack_extension(plane((w, n)), plane((w, n)), v,
                                fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-50.0, 50.0, k, device="cuda"), FS, b, d)
    got = fs.fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, v, windows=w,
                              share_h=s, want_top2=True, sep=3)
    assert got[0].shape == (k, s * w)
    for i in [0, 1, 65_533, 65_534, 65_535, 65_536, 69_999]:
        _assert_bound([t[:, i:i + 1] for t in got],
                      (ws1, ws2, lmat[i // w][None], h_ext[i % w][None]),
                      b, sup, v, 3)


def _pipelined_call(*args, **kw):
    """``fused_stein_rank`` that must take the pipelined launch: its
    answer, after checking that the launch and the pipelined counter
    both rose by one."""
    before = fs.LAUNCHES, fs.PIPELINED_LAUNCHES
    got = fs.fused_stein_rank(*args, **kw)
    torch.cuda.synchronize()
    assert (fs.LAUNCHES, fs.PIPELINED_LAUNCHES) == (before[0] + 1,
                                                    before[1] + 1)
    return got


@pytest.mark.parametrize("shape", ["config2", "config3"])
def test_pipelined_kernel_at_the_cells_shapes_on_card(card, shape):
    """The pipelined launch at config 2's shape (64 pairs, 2B = 128, D =
    64, 400 bins, 8192 lags; ``cookoff.batch64``) and config 3's (c+d)
    (6 bands x 8 windows, 2B = 64, D = 128, 375 bins; ``widearea.capture``),
    each with a ``num_valid`` mask on every program: within the error
    bound of ``rank_bound_check``, no lag at or past its bound."""
    rng = np.random.default_rng(50)
    if shape == "config2":
        needles, hays = _pairs(rng, 64, 4096)
        freqs = np.arange(-100.0, 100.0, 0.5).astype(np.float32)
        ops, b, sup = _operands(needles, hays, freqs, 8192, 64)
        m, modes = 8192, {}
        nv = torch.as_tensor(rng.integers(0, 8193, 64), dtype=torch.int32,
                             device="cuda")
    else:
        ops, b, sup, nv = _modes_operands(rng, 1, 6, 8, 4096, 128, 375, 8192)
        m, modes = 8192, dict(windows=8, share_h=6)
        nv = torch.minimum(nv, torch.as_tensor(
            rng.integers(1, 8193, nv.shape[0]), dtype=torch.int32,
            device="cuda"))
    kv, ki = _pipelined_call(*ops, b, sup, m, num_valid=nv, **modes)
    assert bool((ki < nv.clamp(min=1)[None, :]).all())
    _assert_bound((kv, ki), ops, b, sup, m, num_valid=nv, **modes)


@pytest.mark.parametrize("k", [45, 400, 1000])
@pytest.mark.parametrize("sms", [1, 7, 132, 100_000])
def test_pipelined_kernel_bins_and_splits_on_card(card, monkeypatch, k,
                                                  sms):
    """Bin counts off a multiple of 32 (the last m-tile part empty) and
    every geometry the SM count gives: one block walking every item,
    blocks of odd item counts, bins split over a tile's items.  Every
    split count gives the same values and lags bit for bit (each bin's
    sums are the same), within the error bound."""
    needles, hays = _pairs(np.random.default_rng(51), 2, 1024)
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    ops, b, sup = _operands(needles, hays, freqs, 2100, 32)
    want = _pipelined_call(*ops, b, sup, 2100)
    monkeypatch.setattr(fs, "_sm_count", lambda dev: sms)
    got = _pipelined_call(*ops, b, sup, 2100)
    for a, z in zip(got, want):
        assert torch.equal(a, z)
    _assert_bound(got, ops, b, sup, 2100)


@pytest.mark.parametrize("lags,sms", [((300, 340), 1),    # one thread's lags
                                      ((300, 400), 1),    # tiles 2, 3
                                      ((200, 300), 1),    # tiles 1, 2
                                      ((300, 400), 132)])
def test_pipelined_kernel_ties_go_to_the_lowest_lag_on_card(
        card, monkeypatch, lags, sms):
    """Bit-identical needle copies at two lags tie exactly in every bin.
    With one block a launch its items run back to back, tile t in G
    buffer t % 2: the tie within one thread's lags of a tile, and across
    two consecutive tiles (buffers 0 then 1, and 1 then 0), goes to the
    lower lag at the zero-doppler bin, and every bin is in its bound."""
    rng = np.random.default_rng(52)
    n, d, k, m = 32, 8, 17, 1024
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros((1, m), np.complex64)
    for lag in lags:
        hay[0, lag:lag + n] = needle
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    ops, b, sup = _operands(needle[None], hay, freqs, m, d)
    monkeypatch.setattr(fs, "_sm_count", lambda dev: sms)
    kv, ki = _pipelined_call(*ops, b, sup, m)
    assert int(ki[k // 2, 0]) == min(lags)
    _assert_bound((kv, ki), ops, b, sup, m)


def test_pipelined_launches_only_where_the_plan_takes_them_on_card(card):
    """``PIPELINED_LAUNCHES`` stays put at the stream's shape (2B = 512,
    D = 16), in mode (e) and on the cluster split (2B = 1024, D = 8),
    while ``LAUNCHES`` counts each call."""
    rng = np.random.default_rng(53)
    cases = [(4096, 16, {}), (512, 64, dict(want_top2=True, sep=5)),
             (8192, 8, {})]
    for n, d, kw in cases:
        needles, hays = _pairs(rng, 1, n, hay_len=1024)
        freqs = np.linspace(-2, 2, 24).astype(np.float32)
        ops, b, sup = _operands(needles, hays, freqs, 1024, d)
        before = fs.LAUNCHES, fs.PIPELINED_LAUNCHES
        got = fs.fused_stein_rank(*ops, b, sup, 1024, **kw)
        torch.cuda.synchronize()
        assert (fs.LAUNCHES, fs.PIPELINED_LAUNCHES) == (before[0] + 1,
                                                        before[1])
        _assert_bound(got, ops, b, sup, 1024, kw.get("sep"))


def test_top2_recompute_repeats_its_tile_pass_beside_pipelined_on_card(
        card):
    """Where the single-slot call takes the pipelined launch, mode (e)
    keeps the tile launch for its tile pass and its recompute: the
    recompute repeats the tile pass's |R|^2 bit for bit, so copies tied
    across a recomputed tile still give the lower lag in slot 2 in every
    bin (``test_top2_tie_across_a_recomputed_tile_on_card``'s first
    scene)."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    rng = np.random.default_rng(21)
    n, d, strong, tied, partner, sep, k, v = 128, 32, 1000, 1310, 5000, \
        300, 64, 8192
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(v + n, np.complex64)
    for lag, amp in ((strong, 2.0), (tied, 1.0), (partner, 1.0)):
        hay[lag:lag + n] = amp * needle
    nt = torch.from_numpy(needle).cuda()[None]
    ht = torch.from_numpy(hay).cuda()[None]
    b = n // d
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, v, 1,
                                  fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-100.0, 100.0, k, device="cuda"), FS, b, d)
    ops = (ws1, ws2, lmat, h_ext)
    one = _pipelined_call(*ops, b, sup, v)
    assert one[1].unique().tolist() == [strong]
    before = fs.PIPELINED_LAUNCHES
    got = fs.fused_stein_rank(*ops, b, sup, v, want_top2=True, sep=sep)
    torch.cuda.synchronize()
    assert fs.PIPELINED_LAUNCHES == before
    assert got[1].unique().tolist() == [strong]
    assert got[3].unique().tolist() == [min(tied, partner)]
    _assert_bound(got, ops, b, sup, v, sep)


# Needle lengths at D = 8 whose 2B rows K1 shares over a cluster of c
# blocks a lag tile: 2B = 1024, 2048 and 4608.
SPLIT_NEEDLE = {2: 4096, 4: 8192, 8: 18432}


@pytest.mark.parametrize("mode", ["a", "b", "c+d", "e", "f"])
@pytest.mark.parametrize("c", [2, 4, 8])
def test_kernel_row_split_matches_plain_on_card(card, c, mode):
    """K1 with G's rows shared over a cluster of c blocks a lag tile, in
    modes (a) one pair, (b) three pairs, (c+d) 2 bands x 2 windows with
    num_valid, (e) top-2 over two pairs and (f) rate-major rows (3 rates
    x 40 bins, with (c+d)): every slot within the error bound of
    ``rank_bound_check``, 70 bins (a last pass of 6) where not (f)."""
    n, d, v = SPLIT_NEEDLE[c], 8, 1024
    assert fs.check_kernel_shape(2 * (n // d), d).cluster == c
    p, s, w = {"b": (3, 1, 1), "e": (2, 1, 1), "c+d": (1, 2, 2),
               "f": (1, 2, 2)}.get(mode, (1, 1, 1))
    ops, b, sup, nv = _modes_operands(np.random.default_rng(30 + c), p, s,
                                      w, n, d, 70, v)
    if mode == "f":
        rel = torch.linspace(-100.0, 100.0, 40, device="cuda")
        rates = np.array([-200.0, 0.0, 200.0], np.float32)
        ops = (*fs.stein_rate_synthesis_weights(rel, rates, FS, b, d),
               *ops[2:])
    modes = dict(windows=w, share_h=s, num_valid=nv if w > 1 else None)
    sep = 5 if mode == "e" else None
    before = fs.LAUNCHES
    got = fs.fused_stein_rank(*ops, b, sup, v, want_top2=sep is not None,
                              sep=sep or 0, **modes)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    assert got[0].shape == (ops[0].shape[0], p * s * w)
    _assert_bound(got, ops, b, sup, v, sep, **modes)


def test_kernel_row_split_at_the_ceiling_on_card(card):
    """The most rows the kernel takes at D = 8 (``row_ceiling``): a
    cluster of 16 blocks a lag tile, which the card can hold, within the
    error bound."""
    d = 8
    b2 = fs.row_ceiling(d)
    assert fs.check_kernel_shape(b2, d).cluster == fs.CLUSTER_MAX
    assert fs.kernel_occupancy(b2, d)["max_active_clusters"] >= 1
    ops, b, sup, _ = _modes_operands(np.random.default_rng(40), 1, 1, 1,
                                     b2 // 2 * d, d, 24, 512)
    got = fs.fused_stein_rank(*ops, b, sup, 512)
    _assert_bound(got, ops, b, sup, 512)
    with pytest.raises(VmemBudgetError, match="fused=False"):
        fs.fused_stein_rank(*_modes_operands(
            np.random.default_rng(41), 1, 1, 1, (b2 // 2 + 1) * d, d, 8,
            512)[0], b2 // 2 + 1, sup, 512)


@pytest.mark.parametrize("n", [4096, 8192])
def test_kernel_row_split_tie_break_on_card(card, n):
    """Two bit-identical needle copies at lags 100 and n + 304 tie
    exactly with G's rows shared over 2 and 4 blocks a tile (each lag's
    sum spans every rank's rows): the lowest lag wins in every bin."""
    rng = np.random.default_rng(13)
    d, k = 8, 17
    far = n + 304
    m = far + n
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros((1, far + n), np.complex64)
    hay[0, 100:100 + n] = needle
    hay[0, far:far + n] = needle
    freqs = np.linspace(-2, 2, k).astype(np.float32)
    ops, b, sup = _operands(needle[None], hay, freqs, m, d)
    assert fs.check_kernel_shape(2 * b, d).cluster == n // 2048
    kv, ki = fs.fused_stein_rank(*ops, b, sup, m)
    assert ki[:, 0].tolist() == [100] * k
    _assert_bound((kv, ki), ops, b, sup, m)


@pytest.mark.parametrize("strong,tied,partner", [(1000, 5300, 10000),
                                                 (9000, 4740, 300)])
def test_top2_row_split_tie_across_a_recomputed_tile_on_card(
        card, strong, tied, partner):
    """``test_top2_tie_across_a_recomputed_tile_on_card`` with G's 1024
    rows shared over 2 blocks a tile (n = 4096, D = 8, sep 4250): the
    recompute sums the ranks' partials in the tile pass's order, so the
    tied pair still ties exactly and the lower lag is slot 2."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    rng = np.random.default_rng(22)
    n, d, k, v, sep = 4096, 8, 64, 16384, 4250
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(v + n, np.complex64)
    for lag, amp in ((strong, 2.0), (tied, 1.0), (partner, 1.0)):
        hay[lag:lag + n] = amp * needle
    nt = torch.from_numpy(needle).cuda()[None]
    ht = torch.from_numpy(hay).cuda()[None]
    b = n // d
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, v, 1,
                                  fs.fused_span(b, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-2.0, 2.0, k, device="cuda"), FS, b, d)
    ops = (ws1, ws2, lmat, h_ext)
    assert fs.check_kernel_shape(2 * b, d).cluster == 2
    got = fs.fused_stein_rank(*ops, b, sup, v, want_top2=True, sep=sep)
    assert got[1].unique().tolist() == [strong]
    assert got[3].unique().tolist() == [min(tied, partner)]
    _assert_bound(got, ops, b, sup, v, sep)


def test_stein_peak_wide_doppler_grid_on_card(card):
    """``caf_peak(backend="stein")`` on chirp_0 over -1000...+995 Hz step
    5 (D = 8, 2B = 1024: K1 at 2 blocks a tile) gives the cuFFT
    filterbank's (freq, lag), one K1 launch."""
    pairs = ensure_fixtures(DATA)
    needle = load_c64(pairs[0][0])
    hay = load_c64(pairs[0][1], count=len(needle))
    freqs = FreqGrid(-1000.0, 1000.0, 5.0).frequencies(np.float32)
    before = fs.LAUNCHES
    got = caf_peak(needle, hay, freqs, FS, backend="stein", device="cuda")
    assert fs.LAUNCHES == before + 1
    want = caf_peak(needle, hay, freqs, FS, backend="xla", device="cuda")
    assert got[:2] == want[:2] == (70.0, 202)
    assert got[2] == pytest.approx(want[2], rel=1e-4)


def test_lattice_engines_on_card(card):
    """The fused lattices on the card, each one K1 launch: the
    long-capture lattice equals the cuFFT lattice scan on three emitters,
    and the equal-length lattice equals ``find_peaks`` on the surface."""
    from caf_cookoff_tpu_torch import (batched_overlap_save_peaks_local,
                                       batched_stein_os_peaks,
                                       batched_stein_peaks, caf_surface,
                                       find_peaks, resolution_cell)

    grid = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    rng = np.random.default_rng(5)
    n, total = 1024, 16384
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    truths = [(-30.0, 3000), (45.0, 9000), (10.0, 14000)]
    for amp, (f, lag) in zip((1.0, 0.8, 0.6), truths):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    before = fs.LAUNCHES
    fr, lg, vv = batched_stein_os_peaks(needle[None], hay[None], grid, FS, 4,
                                        device="cuda")
    assert fs.LAUNCHES == before + 1
    fr2, lg2, vv2 = batched_overlap_save_peaks_local(
        needle[None], hay[None], grid, FS, 4, device="cuda")
    rows = [(float(f), int(l)) for f, l in zip(fr[0][:3], lg[0][:3])]
    assert rows == [(float(f), int(l)) for f, l in zip(fr2[0][:3],
                                                       lg2[0][:3])] == truths
    np.testing.assert_allclose(vv[0][:3], vv2[0][:3], rtol=2e-5)
    eq = (needle * np.exp(2j * np.pi * -20.0 * t / FS) + hay[:n]
          + 0.7 * np.roll(needle * np.exp(2j * np.pi * 35.0 * t / FS), 300)
          ).astype(np.complex64)
    before = fs.LAUNCHES
    fr, lg, vv = batched_stein_peaks(needle[None], eq[None], grid, FS, 2,
                                     device="cuda")
    assert fs.LAUNCHES == before + 1
    surf = caf_surface(needle, eq, grid, FS, device="cuda")
    pk = find_peaks(surf, 2, *resolution_cell(needle, grid, FS),
                    lag_period=surf.shape[-1])
    assert [(float(f), int(l)) for f, l in zip(fr[0], lg[0])] == \
        [(float(grid[int(f)]), int(l)) for f, l in zip(pk.freq_idx,
                                                       pk.lag_idx)]
    np.testing.assert_allclose(vv[0], pk.value.cpu().numpy(), rtol=2e-5)


# ---------------------------------------------------------------------------
# K1 mode (f), the rate engines, the refiners, K4
# ---------------------------------------------------------------------------


def _rate_operands(rates, s=3, w=3, n=2048, kb=128, d=64, seed=6):
    """K1 (c+d+f) operands on the card: ``s`` band needles and ``w``
    windows of one capture (the last window cut short), rate-major rows
    of a ``kb``-bin relative grid."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _os_window_extensions)

    rng = np.random.default_rng(seed)
    m = 2 * n
    needles, hays = _pairs(rng, s, n, hay_len=w * m + n)
    nt = torch.from_numpy(needles).cuda()
    ht = torch.from_numpy(hays[:1]).cuda()
    b = n // d
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, m, w,
                                  fs.fused_span(b, sup, m))
    rel = torch.linspace(-150.0, 150.0, kb, device="cuda")
    ws1, ws2 = fs.stein_rate_synthesis_weights(rel, rates, FS, b, d)
    nv = torch.tensor([m] * (w - 1) + [m - 777], dtype=torch.int32,
                      device="cuda").repeat(s)
    return (ws1, ws2, lmat, h_ext), b, sup, m, {
        "windows": w, "share_h": s, "num_valid": nv}


@pytest.mark.parametrize("top2", [False, True])
def test_rate_rows_match_plain_on_card(card, top2):
    """K1 (c+d+f) and (c+d+e+f) at 9 rates x 128 bins = 1152 rate-major
    rows (18 bin passes), 3 bands x 3 windows: every slot within the
    error bound."""
    rates = np.arange(-400.0, 401.0, 100.0, dtype=np.float32)
    ops, b, sup, m, modes = _rate_operands(rates)
    before = fs.LAUNCHES
    got = fs.fused_stein_rank(*ops, b, sup, m, want_top2=top2, sep=3,
                              **modes)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == before + 1
    assert got[0].shape == (9 * 128, 9)
    _assert_bound(got, ops, b, sup, m, 3 if top2 else None, **modes)


def _swept(emitters, n=2048, total=16384, seed=8):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f0, rate, lag, amp in emitters:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f0 * t / FS + 1j * np.pi * rate * (t / FS) ** 2)
        ).astype(np.complex64)
    return needle, hay


def test_rate_engines_on_card_match_cpu(card):
    """The rate engines on the card against their CPU runs (the kernel
    in bf16 there, the plain version in f32 here): the same (rate, freq,
    lag) answers and lattice rows, values within rtol 1e-4; the
    segmented engines launch K1 once a call."""
    from caf_cookoff_tpu_torch import (rate_caf_peak, rate_overlap_save_peak,
                                       rate_overlap_save_peaks,
                                       stein_rate_os_peak,
                                       stein_rate_os_peaks)

    freqs = np.linspace(-500, 500, 400, endpoint=False).astype(np.float32)
    rates = np.arange(-240.0, 241.0, 60.0, dtype=np.float32)
    emitters = [(float(freqs[317]), -180.0, 7000, 1.0),
                (float(freqs[90]), 120.0, 2500, 0.6)]
    needle, hay = _swept(emitters)
    for fn, args in ((stein_rate_os_peak, ()), (rate_overlap_save_peak, ()),
                     (stein_rate_os_peaks, (3,)),
                     (rate_overlap_save_peaks, (3,))):
        before = fs.LAUNCHES
        got = fn(needle, hay, freqs, rates, FS, *args, device="cuda")
        segmented = fn.__name__.startswith("stein")
        assert fs.LAUNCHES - before == (1 if segmented else 0)
        want = fn(needle, hay, freqs, rates, FS, *args, device="cpu")
        if not args:
            f0, rate, lag, _ = emitters[0]
            assert got[:3] == want[:3] == (rate, f0, lag)
            assert got[3] == pytest.approx(want[3], rel=1e-4)
            continue
        for g, w_ in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[:2], w_[:2])
        np.testing.assert_allclose(got[3][:2], want[3][:2], rtol=1e-4)
        assert [(float(r), float(f), int(l)) for r, f, l in
                zip(*got[:3])][:2] == [(r, f, lag) for f, r, lag, _ in
                                       emitters]
    short = hay[6900:6900 + 2048]
    got = rate_caf_peak(needle, short, freqs, rates, FS, device="cuda")
    want = rate_caf_peak(needle, short, freqs, rates, FS, device="cpu")
    assert got[:3] == want[:3]
    assert got[3] == pytest.approx(want[3], rel=1e-4)


def test_refiners_on_card(card):
    """refine_peak on the ten goldens and refine_peak_rate on a swept
    emitter, on the card: within the truth bounds of
    ``tests/test_refine.py`` and of the CPU runs' (0.01 Hz, 0.1 samples;
    0.05 Hz/s after the shared f64 polish)."""
    from caf_cookoff_tpu_torch import refine_peak, refine_peak_rate
    from caf_cookoff_tpu_torch.utils.io import parse_ground_truth

    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    for n_path, h_path in ensure_fixtures(DATA):
        needle, hay = load_c64(n_path), load_c64(h_path)
        gt = parse_ground_truth(h_path)
        f0, lag0, _ = caf_peak(needle, hay[:len(needle)], freqs, FS,
                               backend="xla", device="cuda")
        got = refine_peak(needle, hay, f0, lag0, FS, device="cuda")
        cpu = refine_peak(needle, hay, f0, lag0, FS, device="cpu")
        assert abs(got[0] - gt.freq_hz) <= 0.01
        assert abs(got[1] - gt.lag_samples) <= 0.1
        assert abs(got[0] - cpu[0]) <= 0.01 and abs(got[1] - cpu[1]) <= 0.01
    needle, hay = _swept([(35.99, 3.7, 1234, 1.0)], n=4096)
    got = refine_peak_rate(needle, hay, 36.0, 1234, FS, device="cuda")
    cpu = refine_peak_rate(needle, hay, 36.0, 1234, FS, device="cpu")
    assert abs(got[0] - 35.99) <= 0.01 and abs(got[1] - 3.7) <= 0.25
    assert abs(got[2] - 1234) <= 0.01
    assert abs(got[0] - cpu[0]) <= 1e-3 and abs(got[1] - cpu[1]) <= 0.05


@pytest.mark.parametrize("rows,cols,sweeps", [(416, 8192, 64), (416, 8192, 1),
                                              (3, 1000, 64), (1, 1, 1)])
def test_epilogue_roofline_matches_plain_on_card(card, rows, cols, sweeps):
    """K4 against its plain version, bit for bit, at the TPU script's
    shape and at ragged ones (a row not a multiple of the block)."""
    from caf_cookoff_tpu_torch.utils import roofline as rf

    before = rf.LAUNCHES
    got = rf.epilogue(rows, cols, sweeps, seed=0.5, device="cuda")
    want = rf.epilogue_plain(rows, cols, sweeps, seed=0.5, device="cuda")
    assert rf.LAUNCHES == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        rf.epilogue(rows, cols, 7, device="cuda")


# ---------------------------------------------------------------------------
# StreamingCAF on the card
# ---------------------------------------------------------------------------


def _stream(capture, chunk, needle, freqs, **kw):
    from caf_cookoff_tpu_torch import StreamingCAF

    s = StreamingCAF(needle, freqs, FS, device="cuda", **kw)
    before = fs.LAUNCHES
    chunks = [s.process(capture[i:i + chunk])
              for i in range(0, len(capture), chunk)]
    return s, chunks, fs.LAUNCHES - before


def test_stein_stream_chirp_0_on_card(card):
    """chirp_0's capture in 2048-sample chunks on the 0.25 Hz grid: one K1
    launch a chunk (the last chunk is short: ``num_valid``), the answer
    (69.25, 202), and the CPU stream's answer and chunk values (the
    chunks within K1's bf16 rank, rtol 2e-2)."""
    needle_path, hay_path = ensure_fixtures(DATA)[0]
    needle, capture = load_c64(needle_path), load_c64(hay_path)
    freqs = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
    s, chunks, launches = _stream(capture, 2048, needle, freqs,
                                  backend="stein", chunk_len=2048)
    assert launches == len(chunks) == 3
    assert s.best()[:2] == (69.25, 202)
    from caf_cookoff_tpu_torch import StreamingCAF

    cpu = StreamingCAF(needle, freqs, FS, backend="stein", chunk_len=2048,
                       device="cpu")
    want = [cpu.process(capture[i:i + 2048])
            for i in range(0, len(capture), 2048)]
    for got, exp in zip(chunks, want):
        assert got[2] == pytest.approx(exp[2], rel=2e-2)
    assert chunks[-1][:2] == want[-1][:2] == (69.25, 202)
    assert s.best()[2] == pytest.approx(cpu.best()[2], rel=1e-4)


def _emitters(truths, total, n=1024, seed=7):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in truths:
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    return needle, hay


@pytest.mark.parametrize("truths,total,num_peaks", [
    ([(-30.0, 9000, 1.0), (-30.0, 12000, 0.7)], 32768, 2),
    ([(-30.0, 9000, 1.0), (45.0, 40800, 0.8), (10.0, 60000, 0.6)], 65536,
     4)])
def test_stein_stream_lattice_on_card(card, truths, total, num_peaks):
    """K1's top-2 mode (e) once a 8192-sample chunk: a same-bin pair at
    lags 9000 and 12000 inside one chunk window, and a three-emitter
    lattice with one emitter across a chunk edge — every emitter, in
    order, and the emitters' slots the CPU stream gives."""
    from caf_cookoff_tpu_torch import StreamingCAF

    needle, hay = _emitters(truths, total)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    s, chunks, launches = _stream(hay, 8192, needle, freqs, backend="stein",
                                  num_peaks=num_peaks)
    assert launches == len(chunks)
    fr, lg, vv = s.peaks()
    got = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
           if np.isfinite(float(v))]
    assert got[:len(truths)] == [(f, lag) for f, lag, _ in truths]
    cpu = StreamingCAF(needle, freqs, FS, backend="stein",
                       num_peaks=num_peaks, device="cpu")
    for i in range(0, total, 8192):
        cpu.process(hay[i:i + 8192])
    # The emitters' slots (a spare slot holds a noise rank, which K1's
    # bf16 rounding may order otherwise on the card).
    cf, cl, cv = (x[:len(truths)] for x in cpu.peaks())
    assert fr[:len(truths)].tolist() == cf.tolist()
    assert lg[:len(truths)].tolist() == cl.tolist()
    np.testing.assert_allclose(vv[:len(truths)], cv, rtol=1e-4)


def test_cufft_stream_matches_overlap_save_on_card(card):
    """The cuFFT stream (no kernel) equals ``overlap_save_peak`` on the
    card, with uneven chunks (a 1-sample one and an oversized one)."""
    from caf_cookoff_tpu_torch import overlap_save_peak

    needle, hay = _emitters([(750.0, 5000, 1.0)], 8192, n=256)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    want = overlap_save_peak(needle, hay, freqs, FS, device="cuda")
    from caf_cookoff_tpu_torch import StreamingCAF

    s = StreamingCAF(needle, freqs, FS, chunk_len=1024, device="cuda")
    before = fs.LAUNCHES
    for a, b in [(0, 700), (700, 701), (701, 6000), (6000, 8192)]:
        s.process(hay[a:b])
    assert fs.LAUNCHES == before
    got = s.best()
    assert got[:2] == want[:2] == (750.0, 5000)
    assert got[2] == pytest.approx(want[2], rel=1e-5)
    assert s.samples_seen == 8192


# ---------------------------------------------------------------------------
# parallel/ on the card
# ---------------------------------------------------------------------------


def _stein_os_input(n=2048, total=32768, lag=30720, f_inj=33.0, seed=5):
    """A long capture whose emitter sits at the final full-overlap lag."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    hay[lag:lag + n] += (needle * np.exp(
        2j * np.pi * f_inj * np.arange(n) / FS)).astype(np.complex64)
    return needle, hay, np.arange(-100, 100, 0.5, dtype=np.float32)


def _batch_input(p=4, n=4096, seed=9):
    rng = np.random.default_rng(seed)
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = np.zeros_like(needles)
    for i in range(p):
        lag = 50 + 17 * i
        hays[i, lag:] = needles[i, :n - lag] * np.exp(
            2j * np.pi * (10.0 * i - 30.0) * np.arange(lag, n) / FS)
    return needles, hays, np.arange(-100, 100, 0.5, dtype=np.float32)


def test_parallel_one_nccl_rank_matches_single_device(card):
    """A world of one rank on NCCL: ``sharded_stein_os_peak`` and
    ``sharded_batched_stein_peak`` launch K1 and equal the single-device
    engines bit for bit; ``sharded_caf_peak(backend="pallas")`` launches
    K2 once and equals ``caf_peak``'s."""
    import torch.distributed as dist

    from caf_cookoff_tpu_torch import batched_stein_os_peak, batched_stein_peak
    from caf_cookoff_tpu_torch.parallel import (make_mesh, multihost,
                                                sharded_batched_stein_peak,
                                                sharded_caf_peak,
                                                sharded_stein_os_peak)

    multihost.initialize_cluster(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                 backend="nccl")
    try:
        mesh = make_mesh(device="cuda:0")
        assert mesh.backend == "nccl"
        needle, hay, freqs = _stein_os_input()
        fs.LAUNCHES = 0
        got = sharded_stein_os_peak(needle, hay, freqs, FS, mesh)
        assert fs.LAUNCHES > 0
        s = batched_stein_os_peak(needle[None], hay[None], freqs, FS,
                                  device="cuda")
        assert got == (float(s[0][0]), int(s[1][0]), float(s[2][0]))
        assert got[:2] == (33.0, 30720)
        needles, hays, freqs = _batch_input()
        fs.LAUNCHES = 0
        got = sharded_batched_stein_peak(needles, hays, freqs, FS, mesh)
        assert fs.LAUNCHES > 0
        want = batched_stein_peak(needles, hays, freqs, FS, device="cuda")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # K2 in the doppler shard of the sharded filterbank peak.
        pc.PEAK_LAUNCHES = 0
        got = sharded_caf_peak(needles[1], hays[1], freqs, FS, mesh,
                               backend="pallas")
        assert pc.PEAK_LAUNCHES == 1
        assert got == caf_peak(needles[1], hays[1], freqs, FS,
                               backend="pallas", device="cuda")
    finally:
        dist.destroy_process_group()


_RANK_WORKER = '''
import datetime, json, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as t
from caf_cookoff_tpu_torch.ops import fused_stein as fs
from caf_cookoff_tpu_torch.parallel import (make_mesh, multihost,
                                            sharded_batched_stein_peak,
                                            sharded_stein_os_peak)
multihost.initialize_cluster(backend="gloo",
                             timeout=datetime.timedelta(seconds=120))
out = {}
needle, hay, freqs = t._stein_os_input()
fs.LAUNCHES = 0
out["os"] = sharded_stein_os_peak(
    needle, hay, freqs, t.FS,
    make_mesh(time=2, device="cuda:0", collectives="gloo"))
out["os_k1"] = fs.LAUNCHES
needles, hays, freqs = t._batch_input()
fs.LAUNCHES = 0
got = sharded_batched_stein_peak(
    needles, hays, freqs, t.FS,
    make_mesh(pair=2, device="cuda:0", collectives="gloo"))
out["batch"] = [np.asarray(x).tolist() for x in got]
out["batch_k1"] = fs.LAUNCHES
print("RANK " + json.dumps(out))
dist.destroy_process_group()
'''


def test_parallel_two_gloo_ranks_on_one_card(card, tmp_path):
    """Two ranks on ``cuda:0`` with gloo collectives (NCCL takes one rank
    a card): the time- and pair-sharded K1 engines equal the single-device
    engines on both ranks, and each rank launches K1."""
    import json
    import os
    import sys

    from caf_cookoff_tpu_torch import batched_stein_os_peak, batched_stein_peak
    from caf_cookoff_tpu_torch.parallel import multihost

    here = pathlib.Path(__file__).resolve().parent
    worker = tmp_path / "rank.py"
    worker.write_text(_RANK_WORKER)
    env = dict(os.environ, PYTHONPATH=f"{here.parent}:"
               f"{os.environ.get('PYTHONPATH', '')}")
    outs = multihost.wait_local(multihost.launch_local(
        [sys.executable, str(worker), str(here)], 2, env=env), 300.0)
    needle, hay, freqs = _stein_os_input()
    s = batched_stein_os_peak(needle[None], hay[None], freqs, FS,
                              device="cuda")
    want_os = [float(s[0][0]), int(s[1][0]), float(s[2][0])]
    needles, hays, freqs = _batch_input()
    want_b = batched_stein_peak(needles, hays, freqs, FS, device="cuda")
    for rank, (rc, text) in enumerate(outs):
        assert rc == 0, text[-3000:]
        res = json.loads([ln for ln in text.splitlines()
                          if ln.startswith("RANK ")][0][5:])
        assert res["os"] == want_os, (rank, res["os"], want_os)
        assert res["os_k1"] > 0 and res["batch_k1"] > 0
        assert res["batch"][:2] == [want_b[0].tolist(), want_b[1].tolist()]
        np.testing.assert_allclose(res["batch"][2], want_b[2], rtol=1e-5)


def test_bench_configs_one_cell_on_card(card, capsys):
    """``python -m caf_cookoff_tpu_torch.utils.bench_configs config1
    --rounds 2``: the gate passes, and the line carries the rounds'
    statistics, the profiler's device time and operations, the host share
    and the card; ``headline`` adds ``vs_baseline``."""
    import json

    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    ensure_fixtures(DATA)
    assert bc.main(["config1", "--rounds", "2"]) == 0
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert line["metric"] == "cuda_config1_400x8192_stein_call_ms"
    assert line["gate"] == "passed" and line["rounds"] == 2
    assert 0 < line["best_ms"] <= line["value"] == line["median_ms"]
    assert line["device_ms"] > 0 and line["device_ops"] > 0
    assert line["host_share"] == pytest.approx(
        1 - line["device_ms"] / line["value"])
    assert line["syncs"] == 1       # the compiled call's one read
    assert line["card"].startswith(torch.cuda.get_device_name(0))
    head = bc.headline(line)
    assert head["vs_baseline"] == pytest.approx(bc.BASELINE_MS
                                                / line["value"])


def test_bench_scaling_one_rank_on_card(card, capsys):
    """``python -m caf_cookoff_tpu_torch.utils.bench_scaling --procs 1``
    for doppler and time: one NCCL rank in a child process, each point
    gated, then timed, with no efficiency; more ranks are refused."""
    import json

    from caf_cookoff_tpu_torch.utils import bench_scaling as bs

    ensure_fixtures(DATA)
    assert bs.main(["--procs", "1", "--engines", "doppler,time",
                    "--rounds", "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["engine"] for ln in lines] == ["doppler", "time"]
    for ln in lines:
        assert ln["n"] == 1 and ln["gate"] == "passed"
        assert ln["collectives"] == "nccl" and ln["device"] == "cuda"
        assert ln["full_ms"] > 0 and ln["compute_ms"] > 0
        assert "efficiency" not in ln
    with pytest.raises(ValueError, match="N = 1 only"):
        bs.run(["doppler"], [1, 2], "cuda")


# ---------------------------------------------------------------------------
# The compiled call (ops/_graph): one CUDA graph per static key
# ---------------------------------------------------------------------------


def _golden(idx, grid):
    needle_path, hay_path = ensure_fixtures(DATA)[idx]
    needle = load_c64(needle_path)
    return (torch.from_numpy(needle).cuda(),
            torch.from_numpy(load_c64(hay_path, count=len(needle))).cuda(),
            FreqGrid(*grid).frequencies(np.float32))


def _same_bits(a, b):
    """The packed answers' bits: values, frequency bins and lags."""
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


def _replay_and_eager(core, traced, static, *_):
    """A replay of the key's graph (captured first if it is not kept)
    and the eager core on the same inputs."""
    from caf_cookoff_tpu_torch.ops import _graph

    _graph.compiled(core, traced, static)
    captures = _graph.CAPTURES
    got = _graph.compiled(core, traced, static)
    assert _graph.CAPTURES == captures
    return got, core(*traced, *static)


def _wide_calls():
    """chirp_0 on wide1000's grid (one program, D = 8, G's rows over a
    cluster) and on +-3000 Hz (banded)."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call

    n, h, _ = _golden(0, GOLDEN[0][1])
    return [_stein_call(n, h, FreqGrid(-span, span, step).frequencies(
        np.float32), FS, 64, True, None, "cuda")
            for span, step in ((1000.0, 5.0), (3000.0, 25.0))]


def _batch_calls(pairs=8):
    """A config-2 batch (its recipe, 8 pairs) on the bench grid and on
    +-3000 Hz (banded)."""
    from caf_cookoff_tpu_torch.models.batched_stein import _batched_call
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needles, hays, freqs, _, _ = bc.build_config2(pairs=pairs)
    ns, hs = torch.from_numpy(needles).cuda(), torch.from_numpy(hays).cuda()
    wide = FreqGrid(-3000.0, 3000.0, 25.0).frequencies(np.float32)
    return [_batched_call(ns, hs, g, FS, 64, True, "cuda")
            for g in (freqs, wide)]


@pytest.mark.parametrize("idx,grid,want_freq,want_lag", GOLDEN)
def test_compiled_call_is_the_eager_core_goldens_on_card(
        card, idx, grid, want_freq, want_lag):
    """``stein_caf_peak``'s replayed graph is its eager core bit for bit
    (value bits, bin, lag) on every golden, K1 fused."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call

    call = _stein_call(*_golden(idx, grid), FS, 64, True, None, "cuda")
    assert call[2][-1] is True
    got, want = _replay_and_eager(*call)
    assert _same_bits(got, want)
    assert float(call[3][int(got[1])]) == pytest.approx(want_freq, abs=1e-4)
    assert int(got[2]) == want_lag


def test_compiled_call_is_the_eager_core_wide_and_batched_on_card(card):
    """wide1000, a banded +-3000 Hz grid, a config-2 batch and the
    banded batch: each replay bit for bit its eager core."""
    from caf_cookoff_tpu_torch.models.batched_stein import _banded_core

    calls = _wide_calls() + _batch_calls()
    assert [c[0] is _banded_core for c in calls] == [False, True, False,
                                                     True]
    for call in calls:
        got, want = _replay_and_eager(*call)
        assert _same_bits(got, want), call[0].__qualname__


def test_second_grid_of_the_same_size_replays_on_card(card):
    """A new grid of the same K replays the captured graph (no capture)
    and gives the eager answer for that grid."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph

    n, h, freqs = _golden(0, GOLDEN[0][1])
    first = _stein_call(n, h, freqs, FS, 64, True, None, "cuda")
    _graph.compiled(*first[:3])
    second = _stein_call(n, h, freqs + np.float32(0.125), FS, 64, True, None,
                         "cuda")
    assert (_graph.static_key(*first[:3])
            == _graph.static_key(*second[:3]))
    captures = _graph.CAPTURES
    got = _graph.compiled(*second[:3])
    assert _graph.CAPTURES == captures
    assert _same_bits(got, second[0](*second[1], *second[2]))
    assert float(second[3][int(got[1])]) != float(freqs[int(got[1])])


def test_main_path_makes_no_sync_on_card(card):
    """With the signals on the card: the plans, the eager cores and a
    replay raise nothing under ``set_sync_debug_mode("error")``; only
    reading the answer waits."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph

    n, h, freqs = _golden(0, GOLDEN[0][1])
    calls = [_stein_call(n, h, freqs, FS, 64, True, None, "cuda")]
    calls += _wide_calls() + _batch_calls()
    for call in calls:
        _graph.compiled(*call[:3])       # captured outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _stein_call(n, h, freqs, FS, 64, True, None, "cuda")
        for core, traced, static, *_ in calls:
            core(*traced, *static)
            _graph.compiled(core, traced, static)
        with pytest.raises(RuntimeError, match="synchroniz"):
            calls[0][0](*calls[0][1], *calls[0][2]).cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_launches_count_replays_on_card(card):
    """K1's counters count every replay's launch (and the split one of
    wide1000), not the capture."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph

    n, h, freqs = _golden(9, GOLDEN[9][1])
    call = _stein_call(n, h, freqs + np.float32(0.0625), FS, 64, True, None,
                       "cuda")
    wide = _wide_calls()[0]
    before = fs.LAUNCHES, fs.SPLIT_LAUNCHES
    for _ in range(3):
        _graph.compiled(*call[:3])
        _graph.compiled(*wide[:3])
    assert (fs.LAUNCHES, fs.SPLIT_LAUNCHES) == (before[0] + 6,
                                                before[1] + 3)
    keys = [k for k, ms, pool in _graph.entries()
            if k[0] in (call[0], wide[0])]
    assert keys and all(ms > 0 and pool >= 0
                        for k, ms, pool in _graph.entries())


def _profiled_on_card(fn):
    """``fn()`` under a CPU and CUDA profiler: its answer and its
    ``caf.`` spans as ``tests/test_torch_spans.span_tree`` nests them;
    no span has a copy on the device's timeline."""
    from torch.profiler import ProfilerActivity, profile

    from test_torch_spans import span_tree

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("caf.")
                and e.device_type() != torch.autograd.DeviceType.CPU]
    return out, span_tree(prof)


REPLAY_SPANS = ("caf.graph", (("caf.graph.copy_in", ()),
                              ("caf.graph.launch", ()),
                              ("caf.graph.copy_out", ())))


def test_replay_spans_under_the_profiler_on_card(card):
    """A replay under the profiler opens ``caf.graph`` with its three
    children and no capture, and answers as the eager core, bit for
    bit."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph

    n, h, freqs = _golden(3, GOLDEN[3][1])
    core, traced, static, *_ = _stein_call(n, h, freqs, FS, 64, True, None,
                                           "cuda")
    _graph.compiled(core, traced, static)
    captures = _graph.CAPTURES
    got, tree = _profiled_on_card(
        lambda: _graph.compiled(core, traced, static))
    assert _graph.CAPTURES == captures
    assert tree == (REPLAY_SPANS,)
    assert _same_bits(got, core(*traced, *static))


def test_public_calls_spans_on_card(card):
    """``stein_caf_peak`` and a Stein stream on the card: each layer's
    span, the replays' among them; a key's first call shows its
    capture."""
    from caf_cookoff_tpu_torch import StreamingCAF, stein_caf_peak

    n, h, freqs = _golden(4, GOLDEN[4][1])
    stein_caf_peak(n, h, freqs, FS)
    got, tree = _profiled_on_card(lambda: stein_caf_peak(n, h, freqs, FS))
    assert got == stein_caf_peak(n, h, freqs, FS)
    assert tree == (("caf.call", (("caf.prep", ()), REPLAY_SPANS,
                                  ("caf.read", ()))),)
    hay = h.cpu().numpy()

    def stream():
        s = StreamingCAF(n, freqs, FS, chunk_len=2048, backend="stein")
        return [s.process(hay[i:i + 2048]) for i in (0, 2048)], s.best()

    stream()
    got, tree = _profiled_on_card(stream)
    assert got == stream()
    chunk = ("caf.stream.chunk", (("caf.stream.upload", ()), REPLAY_SPANS,
                                  ("caf.read", ())))
    assert tree == (
        ("caf.stream.build", (("caf.prep", ()),
                              ("caf.stream.operator", ()))),
        chunk, chunk,
        ("caf.stream.best", (REPLAY_SPANS, ("caf.read", ()))))
    fresh = torch.cat([n, n[:16]])      # a new shape: a new key
    _, tree = _profiled_on_card(lambda: stein_caf_peak(
        fresh, torch.cat([h, h[:16]]), freqs, FS))
    assert tree[0][1][1] == ("caf.graph", (("caf.graph.capture", ()),))


def test_copy_counters_count_a_replays_bytes_on_card(card):
    """Each replay adds its key's input bytes to ``COPY_IN_BYTES`` and
    its outputs' to ``COPY_OUT_BYTES``; a capture adds nothing."""
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph

    n, h, freqs = _golden(5, GOLDEN[5][1])
    # 397 bins: a grid no other test's key has, so the first call
    # captures.
    core, traced, static, *_ = _stein_call(n, h, freqs[:397], FS, 64, True,
                                           None, "cuda")
    counts = lambda: (_graph.COPY_IN_BYTES, _graph.COPY_OUT_BYTES)  # noqa
    before, captures = counts(), _graph.CAPTURES
    out = _graph.compiled(core, traced, static)
    assert _graph.CAPTURES == captures + 1 and counts() == before
    ins = sum(t.numel() * t.element_size() for t in traced)
    outs = out.numel() * out.element_size()
    assert ins == 2 * 4096 * 8 + 4 * 397
    for i in range(1, 4):
        _graph.compiled(core, traced, static)
        assert counts() == (before[0] + i * ins, before[1] + i * outs)
    key = _graph.static_key(core, traced, static)
    assert [(i, o) for k, i, o in _graph.copy_bytes() if k == key] == [
        (ins, outs)]


def test_failed_capture_raises_and_keeps_nothing_on_card(card):
    """A core the card cannot capture (it reads a value back) raises,
    keeps no graph and leaves the caller's stream current."""
    from caf_cookoff_tpu_torch.ops import _graph

    def reads_back(x):
        return x * float(x.sum())

    x = torch.ones(4, device="cuda")
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError, match="capture of"):
        _graph.compiled(reads_back, (x,))
    assert torch.cuda.current_stream() == stream
    assert not [k for k, *_ in _graph.entries() if k[0] is reads_back]
    assert float((x * 2.0).sum()) == 8.0


# ---------------------------------------------------------------------------
# The streams and the windowed engines as compiled calls
# ---------------------------------------------------------------------------


def _tensor_bits(t):
    t = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
    return t.dtype, tuple(t.shape), t.contiguous().view(-1).view(torch.uint8)


def _same_outputs(a, b):
    a = (a,) if isinstance(a, torch.Tensor) else tuple(a)
    b = (b,) if isinstance(b, torch.Tensor) else tuple(b)
    return len(a) == len(b) and all(
        x[:2] == y[:2] and torch.equal(x[2], y[2])
        for x, y in zip(map(_tensor_bits, a), map(_tensor_bits, b)))


def _all_outputs(out, occupant):
    """A compiled call's outputs; an occupant's carried ones read from
    its inputs, where the call left them."""
    if occupant is None:
        return out
    carried, rest = dict(occupant.carried), iter(out)
    return tuple(occupant.inputs[carried[j]] if j in carried else next(rest)
                 for j in range(len(out) + len(carried)))


@pytest.fixture
def checked(monkeypatch):
    """Every compiled call, then its eager core on the same inputs under
    ``set_sync_debug_mode("error")``: a log of (core name, same bits)."""
    from caf_cookoff_tpu_torch.ops import _graph

    compiled, log = _graph.compiled, []

    def check(core, traced, static=(), occupant=None):
        # An occupant's call moves its inputs on: keep them as it reads
        # them.
        inputs = (traced if occupant is None
                  else tuple(t.clone() for t in traced))
        out = compiled(core, traced, static, occupant=occupant)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = core(*inputs, *static)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log.append((core.__name__,
                    _same_outputs(_all_outputs(out, occupant), eager)))
        return out

    monkeypatch.setattr(_graph, "compiled", check)
    return log


def _stream3(bins=None):
    """stream3's needle, capture, two-emitter capture and grid on the card
    (``bins``: stream1000's +-1000 Hz grid)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needle, hay, two, freqs, _, _ = bc.build_stream3()
    if bins:
        freqs = np.linspace(-1000, 1000, bins, endpoint=False).astype(
            np.float32)
    return (torch.from_numpy(needle).cuda(), torch.from_numpy(hay).cuda(),
            torch.from_numpy(two).cuda(), freqs)


STREAM_ENGINES = [("stein", {"backend": "stein"}, None),
                  ("cufft", {}, None),
                  ("stein_lattice", {"backend": "stein", "num_peaks": 3},
                   None),
                  ("stein_1000", {"backend": "stein"}, 2000)]


def _run_stream(needle, capture, freqs, chunk=8192, **kw):
    from caf_cookoff_tpu_torch import StreamingCAF

    s = StreamingCAF(needle, freqs, FS, chunk_len=chunk, device="cuda", **kw)
    chunks = [s.process(capture[i:i + chunk])
              for i in range(0, capture.shape[-1], chunk)]
    return s, chunks


@pytest.mark.parametrize("name,kw,bins", STREAM_ENGINES,
                         ids=[e[0] for e in STREAM_ENGINES])
def test_stream_replays_are_the_eager_steps_on_card(card, checked, name, kw,
                                                    bins):
    """stream3's streams (and stream1000's Stein stream): every chunk's
    compiled step — the first call of its key and every replay, the short
    last chunk's among them — and best() / peaks()' re-score equal their
    eager cores bit for bit, which raise nothing under sync-debug
    "error"."""
    needle, hay, two, freqs = _stream3(bins)
    s, chunks = _run_stream(needle, two if "lattice" in name else hay, freqs,
                            **kw)
    s.peaks() if "lattice" in name else s.best()
    assert len(chunks) == 9
    steps = [n for n, _ in checked if "step" in n]
    assert len(steps) == 9
    assert all(same for _, same in checked), checked
    if name != "cufft":
        assert "_stein_lattice_rescore" in dict(checked)


@pytest.mark.parametrize("name,kw,bins", STREAM_ENGINES,
                         ids=[e[0] for e in STREAM_ENGINES])
def test_stream_makes_one_sync_a_chunk_on_card(card, name, kw, bins):
    """``process`` waits on the card once a chunk (its packed peak's
    read): the profiler counts one sync a chunk, on a stream whose keys
    were captured by an earlier one."""
    from caf_cookoff_tpu_torch import StreamingCAF
    from caf_cookoff_tpu_torch.utils.bench_configs import _device_work

    needle, hay, two, freqs = _stream3(bins)
    capture = two if "lattice" in name else hay
    _run_stream(needle, capture, freqs, **kw)
    s = StreamingCAF(needle, freqs, FS, chunk_len=8192, device="cuda", **kw)
    chunks = iter(capture[i:i + 8192]
                  for i in range(0, capture.shape[-1], 8192))
    _, _, syncs, _ = _device_work(lambda: s.process(next(chunks)), 9)
    assert syncs == 1.0


@pytest.mark.parametrize("name,kw,bins", STREAM_ENGINES,
                         ids=[e[0] for e in STREAM_ENGINES])
def test_second_stream_of_the_same_shapes_captures_nothing_on_card(
        card, name, kw, bins):
    """A second stream of the same shapes, other values (the capture
    scaled, the grid shifted), replays the first one's graphs: no
    capture, and its chunks are the eager steps' (checked elsewhere)."""
    from caf_cookoff_tpu_torch.ops import _graph

    needle, hay, two, freqs = _stream3(bins)
    capture = two if "lattice" in name else hay
    first, _ = _run_stream(needle, capture, freqs, **kw)
    first.peaks() if "lattice" in name else first.best()
    captures = _graph.CAPTURES
    second, chunks = _run_stream(needle * 0.5, capture * 2.0,
                                 freqs + np.float32(0.25), **kw)
    second.peaks() if "lattice" in name else second.best()
    assert _graph.CAPTURES == captures
    assert len(chunks) == 9


# The streams' resident path (ops/_graph.Occupant): against today's
# copy-all path, two streams of one key, an evicted graph, the copies.

RESIDENT_MODES = {"stein": {"backend": "stein"},
                  "stein_lattice": {"backend": "stein", "num_peaks": 3},
                  "cufft": {}, "cufft_lattice": {"num_peaks": 3}}
RESIDENT_FREQS = np.arange(-1000.0, 1000.0, 125.0, dtype=np.float32)
# On a pinned length of 512: full, short, oversized (512 + 512 + 276),
# uneven, and the last.
RESIDENT_SPLITS = [0, 512, 900, 2200, 2601, 3000]


def _resident_scene(cdtype=np.complex64, seed=3, n=256, total=3000):
    """A needle and a capture over noise, two emitters (the second across
    a chunk edge)."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(cdtype)
    cap = (0.05 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(cdtype)
    t = np.arange(n)
    for f, lag, amp in ((250.0, 700, 1.0), (-500.0, 2100, 0.7)):
        cap[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(cdtype)
    return needle, cap


def _resident_stream(needle, mode, **kw):
    from caf_cookoff_tpu_torch import StreamingCAF

    return StreamingCAF(needle, RESIDENT_FREQS, FS, chunk_len=512,
                        device="cuda", **RESIDENT_MODES[mode], **kw)


class _CopyAll:
    """Today's path: a stream's steps through the copy-all compiled call
    (a key of its own), the state carried in Python, from the stream's
    inputs before its first chunk."""

    def __init__(self, s):
        self.s, occ = s, s._occupant
        self.core, self.static = occ.core, occ.static
        self.inputs = [None if t is None else t.clone() for t in occ.inputs]

    def process(self, chunk):
        fixed = self.s._chunk_len
        steps = [self._step(chunk[o:o + fixed])
                 for o in range(0, chunk.shape[-1], fixed)]
        return max(steps, key=lambda r: r[2])

    def _step(self, chunk):
        from caf_cookoff_tpu_torch.models.streaming import (_CARRIED, _CHUNK,
                                                            _VALID)
        from caf_cookoff_tpu_torch.ops import _graph
        from caf_cookoff_tpu_torch.ops.xcor import pad_to
        from caf_cookoff_tpu_torch.utils.convert import as_signal

        s, c, valid = self.s, self.s._consts, int(chunk.shape[-1])
        x = as_signal(chunk, chunk.device if isinstance(chunk, torch.Tensor)
                      else "cpu")
        self.inputs[c + _CHUNK] = pad_to(x.to(s.device).to(s._cdtype),
                                         s._chunk_len)
        self.inputs[c + _VALID] = torch.full((1,), valid, dtype=torch.int32,
                                             device=s.device)
        out = _graph.compiled(self.core, self.inputs, self.static)
        for o, i in _CARRIED:
            self.inputs[c + i] = out[o]
        value, f, lag = out[-1].tolist()
        return float(s._freqs[int(f)]), int(lag), value


def _carried_state(s, inputs):
    from caf_cookoff_tpu_torch.models.streaming import _CARRIED

    return [inputs[s._consts + i] for _, i in _CARRIED]


def _answer(s):
    if s._num_peaks > 1:
        return [x.tolist() for x in s.peaks()]
    return s.best()


@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("mode", list(RESIDENT_MODES))
def test_resident_stream_is_the_copy_all_path_on_card(card, mode, cdtype):
    """Each step kind on the resident path against today's copy-all
    path, over numpy, host-tensor and card-tensor chunks (short,
    oversized, uneven): every chunk's peak and the carried state after
    every chunk, bit for bit; then best() / peaks() of the stream and of
    a stream given today's state (each reading its state where it lies:
    its own tensors after a switch, the graph's buffers), equal."""
    from caf_cookoff_tpu_torch.models.streaming import _CARRIED

    needle, cap = _resident_scene(cdtype)
    s = _resident_stream(needle, mode)
    today = _CopyAll(s)
    for i, (a, b) in enumerate(zip(RESIDENT_SPLITS[:-1],
                                   RESIDENT_SPLITS[1:])):
        chunk = cap[a:b]
        chunk = (chunk, torch.from_numpy(chunk.copy()),
                 torch.from_numpy(chunk.copy()).cuda())[i % 3]
        assert s.process(chunk) == today.process(chunk)
        assert _same_outputs(_carried_state(s, s._occupant.inputs),
                             _carried_state(s, today.inputs))
    given = _resident_stream(needle, mode)
    for _, i in _CARRIED:
        given._write(i, today.inputs[s._consts + i])
    assert _answer(s) == _answer(given)


def test_two_streams_of_one_key_in_turns_on_card(card):
    """Two live Stein streams of one key, fed a chunk each in turn: each
    answers as it does alone, bit for bit, and every change of occupant
    (the second one's build, then every chunk) is a switch."""
    from caf_cookoff_tpu_torch.ops import _graph

    needle, cap = _resident_scene()
    caps = (cap, np.ascontiguousarray(cap[::-1]))
    edges = list(range(0, len(cap), 512))

    def alone(c):
        s = _resident_stream(needle, "stein")
        return [s.process(c[e:e + 512]) for e in edges], s.best()

    want = [alone(c) for c in caps]
    switches = _graph.SWITCHES
    streams = [_resident_stream(needle, "stein") for _ in caps]
    got = [[], []]
    for e in edges:
        for j, (s, c) in enumerate(zip(streams, caps)):
            got[j].append(s.process(c[e:e + 512]))
    assert _graph.SWITCHES - switches == 1 + 2 * len(edges)
    assert [(g, s.best()) for g, s in zip(got, streams)] == want


def test_stream_whose_graph_was_evicted_stays_exact_on_card(card):
    """A stream keeps its graph when the LRU drops its key: it replays
    that graph, exact, with its state in its buffers."""
    from caf_cookoff_tpu_torch.ops import _graph

    needle, cap = _resident_scene()
    edges = list(range(0, len(cap), 512))
    ref = _resident_stream(needle, "stein")
    want = [ref.process(cap[e:e + 512]) for e in edges], ref.best()
    del ref
    s = _resident_stream(needle, "stein")
    got = [s.process(cap[:512])]
    cache = _graph._CACHES[torch.device("cuda", torch.cuda.current_device())]
    entry = cache.get(s._occupant.key)
    bound, cache.bound = cache.bound, 0
    cache.put(("filler",), entry)       # the LRU drops every graph
    cache.bound = bound
    assert len(cache) == 0
    got += [s.process(cap[e:e + 512]) for e in edges[1:]]
    assert (got, s.best()) == want
    assert s._occupant.inputs is entry.inputs


def test_placed_stream_copies_only_its_samples_on_card(card):
    """stream3's Stein stream built with its chunk length on a captured
    key: its 9 host chunks replay resident, with no switch, each copying
    in its samples alone (the short last one its valid length too)."""
    import gc

    from caf_cookoff_tpu_torch import StreamingCAF
    from caf_cookoff_tpu_torch.ops import _graph

    needle, hay, _, freqs = _stream3()
    hay = hay.cpu().numpy()
    _run_stream(needle, hay, freqs, backend="stein")
    gc.collect()
    s = StreamingCAF(needle, freqs, FS, chunk_len=8192, device="cuda",
                     backend="stein")
    resident, switches = _graph.RESIDENT_REPLAYS, _graph.SWITCHES
    chunks = [hay[i:i + 8192] for i in range(0, len(hay), 8192)]
    assert len(chunks) == 9 and len(chunks[-1]) < 8192
    for chunk in chunks:
        before = _graph.COPY_IN_BYTES
        s.process(chunk)
        assert _graph.COPY_IN_BYTES - before == (
            chunk.size * 8 + 4 * (len(chunk) < 8192))
    assert (_graph.RESIDENT_REPLAYS - resident,
            _graph.SWITCHES - switches) == (9, 0)


def _windowed_calls():
    """config3 and config4 on their bench grids (banded) and on +-100 Hz
    step 0.5 (one band), through batched_stein_os_peak's plan."""
    from caf_cookoff_tpu_torch.models.batched_stein import _os_call
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    narrow = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    calls = []
    for build in (bc.build_config3, bc.build_config4):
        ns, hs, freqs, lags = build()[:4]
        ns, hs = torch.from_numpy(ns).cuda(), torch.from_numpy(hs).cuda()
        calls += [_os_call(ns, hs, g, FS, lags, 64, "cuda")
                  for g in (freqs, narrow)]
    return calls


def test_windowed_replays_are_the_eager_cores_on_card(card):
    """batched_stein_os_peak's replayed graphs equal their eager cores
    bit for bit at config3 and config4, banded and not; one sync a
    call."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _banded_os_core, batched_stein_os_peak)
    from caf_cookoff_tpu_torch.utils import bench_configs as bc
    from caf_cookoff_tpu_torch.utils.bench_configs import _device_work

    calls = _windowed_calls()
    assert [c[0] is _banded_os_core for c in calls] == [True, False] * 2
    for call in calls:
        got, want = _replay_and_eager(*call)
        assert _same_bits(got, want), call[0].__qualname__
    ns, hs, freqs, lags = bc.build_config3()[:4]
    ns, hs = torch.from_numpy(ns).cuda(), torch.from_numpy(hs).cuda()
    batched_stein_os_peak(ns, hs, freqs, FS, num_lags=lags, device="cuda")
    _, _, syncs, _ = _device_work(lambda: batched_stein_os_peak(
        ns, hs, freqs, FS, num_lags=lags, device="cuda"), 3)
    assert syncs == 1.0


def test_windowed_eager_cores_make_no_sync_on_card(card):
    from caf_cookoff_tpu_torch.ops import _graph

    calls = _windowed_calls()
    for call in calls:
        _graph.compiled(*call[:3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for core, traced, static, *_ in calls:
            core(*traced, *static)
            _graph.compiled(core, traced, static)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# K5, the Stein exact re-score (ops/stein_rescore), against its plain
# chain on the card: the candidates bit for bit, each row's value within
# FB_RTOL and its lag equal (or, in a near-tied row, within FB_RTOL of
# the row's maximum), the answers equal.

def _k5_rows_plain(ns, hs, freqs, cand, m, bound=None):
    """Each (pair, slot) row's (max, first lag) by torch.fft, over the
    lags up to ``bound``, and the rows themselves."""
    from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2

    rows = mag2(_surface_rows(ns, hs, freqs[cand.long()], FS, m))
    if bound is not None:
        ok = torch.arange(m, device=rows.device)[None, :] <= bound[:, None]
        rows = torch.where(ok[:, None, :], rows, -1.0)
    vals, lags = rows.max(-1)
    return vals, lags, rows


def _assert_k5_matches_plain(ns, hs, freqs, ranking, m, needle_len,
                             num_valid=None, bound=None):
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    before = rs.RESCORE_LAUNCHES
    got = rs.rescore_kernel(ns, hs, freqs, ranking, FS, m, needle_len,
                            num_valid, bound)
    torch.cuda.synchronize()
    assert rs.RESCORE_LAUNCHES == before + 1
    cand = rs._refine_candidates(ranking, freqs, needle_len, FS, num_valid)
    assert torch.equal(got.cand, cand)
    pv, pl, rows = _k5_rows_plain(ns, hs, freqs, cand, m, bound)
    torch.testing.assert_close(got.vals, pv, rtol=FB_RTOL, atol=0)
    at = torch.gather(rows, 2, got.lags.long()[..., None])[..., 0]
    assert bool((at >= (1 - FB_RTOL) * pv).all())
    assert (got.lags == pl.to(torch.int32)).float().mean().item() >= LAG_SHARE
    if bound is not None:
        assert bool((got.lags <= bound[:, None]).all())
    want = rs.rescore_plain(ns, hs, freqs, ranking, FS, m, needle_len,
                            num_valid, bound)
    assert torch.equal(got.peak.freq_idx, want.freq_idx)
    assert torch.equal(got.peak.lag_idx, want.lag_idx)
    torch.testing.assert_close(got.peak.value, want.value, rtol=FB_RTOL,
                               atol=0)
    return got


K5_CANDIDATE_CASES = [
    # name, K, rounding of the values (duplicates), num_valid, grid step Hz
    ("duplicates", 400, 16.0, None, 0.5),
    ("inf_padding", 420, 8.0, 400, 0.5),
    ("k_below_12", 5, 4.0, None, 0.5),
    ("k_of_1", 1, 4.0, None, 0.5),
    ("sep_past_k", 9, 4.0, None, 0.001),
]


@pytest.mark.parametrize("name,k,quant,num_valid,step", K5_CANDIDATE_CASES,
                         ids=[c[0] for c in K5_CANDIDATE_CASES])
def test_rescore_candidates_bit_for_bit_on_card(card, name, k, quant,
                                                num_valid, step):
    """K5's candidates are ``_refine_candidates``' integers bit for bit,
    on rankings of 4 pairs with many equal values, -inf past
    ``num_valid``, K < 12 and a mainlobe wider than the grid (sep >= K),
    and the rows behind them hold to the plain chain."""
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    rng = np.random.default_rng(k)
    p, n, m = 4, 1024, 2048
    needles, hays = _pairs(rng, p, n)
    ranking = torch.from_numpy(np.floor(quant * rng.random((p, k))).astype(
        np.float32)).cuda()
    if num_valid is not None:
        ranking[:, num_valid:] = -np.inf
    freqs = (step * (torch.arange(k, device="cuda") - k // 2)).float()
    got = _assert_k5_matches_plain(
        torch.from_numpy(needles).cuda(), torch.from_numpy(hays).cuda(),
        freqs, ranking, m, n, num_valid)
    n_plain, n_sep = rs._num_picks(k, num_valid)
    assert got.cand.shape == (p, n_plain + n_sep)
    if name == "sep_past_k":
        assert bool((got.cand[:, n_plain + 1:] == 0).all())


def test_rescore_rejects_bad_operands_on_card(card):
    """K5's call raises on a ranking or grid off f32, a ranking on another
    device and a lag bound of another shape, before any launch."""
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    n = torch.ones((2, 64), dtype=torch.complex64, device="cuda")
    ranking = torch.rand((2, 9), device="cuda")
    freqs = torch.arange(9.0, device="cuda")
    before = rs.RESCORE_LAUNCHES
    with pytest.raises(TypeError, match="f32"):
        rs.rescore_kernel(n, n, freqs.double(), ranking, FS, 128, 64)
    with pytest.raises(ValueError, match="must all be on"):
        rs.rescore_kernel(n, n, freqs, ranking.cpu(), FS, 128, 64)
    with pytest.raises(ValueError, match="lag bounds"):
        rs.rescore_kernel(n, n, freqs, ranking, FS, 128, 64,
                          lag_bound=torch.zeros(3, device="cuda"))
    assert rs.RESCORE_LAUNCHES == before


def test_rescore_refuses_what_k5_cannot_hold_on_card(card):
    """On the card only K5 re-scores: complex128 signals and an M past
    K2's range raise before any launch, through the wrapper and through
    a public engine (its f64 segmented rank, fused=False, so the refusal
    is the re-score's), and no plain chain runs in their place."""
    from caf_cookoff_tpu_torch import stein_caf_peak
    from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    n = torch.ones((2, 64), dtype=torch.complex64, device="cuda")
    ranking = torch.rand((2, 9), device="cuda")
    freqs = torch.arange(9.0, device="cuda")
    before = rs.RESCORE_LAUNCHES
    with pytest.raises(EligibilityError, match="complex64"):
        rs.stein_rescore(n.to(torch.complex128), n.to(torch.complex128),
                         freqs, ranking, FS, 128, 64)
    with pytest.raises(VmemBudgetError, match="Stein re-score kernel"):
        rs.stein_rescore(n, n, freqs, ranking, FS, 2 * rs.MAX_FFT_LEN, 64)
    needle, hay, grid = _golden(0, GOLDEN[0][1])
    with pytest.raises(EligibilityError, match="complex64"):
        stein_caf_peak(needle.to(torch.complex128), hay.to(torch.complex128),
                       grid, FS, fused=False, device="cuda")
    assert rs.RESCORE_LAUNCHES == before


def _k5_batch(pairs):
    """config2's pairs (bench grid) and K1's coarse ranking of them."""
    from caf_cookoff_tpu_torch.models.batched_stein import (_batch_operands,
                                                            _coarse_rank)
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needles, hays, freqs, _, _ = bc.build_config2(pairs=pairs)
    ns, hs = torch.from_numpy(needles).cuda(), torch.from_numpy(hays).cuda()
    freqs = torch.from_numpy(freqs).cuda()
    ops, b, sup, _ = _batch_operands(ns, hs, freqs, FS, 8192, 64)
    vals, _ = _coarse_rank(*ops, b, sup, 8192, want_idxs=False)
    return ns, hs, freqs, vals.T.contiguous()


@pytest.mark.parametrize("pairs", [1, 64])
def test_rescore_matches_plain_at_the_cookoff_shapes_on_card(card, pairs):
    """P = 1 and P = 64 pairs, K = 400, M = 8192 (cookoff.single and
    cookoff.batch64), on K1's ranking."""
    _assert_k5_matches_plain(*_k5_batch(pairs), 8192, 4096)


def test_rescore_matches_plain_banded_with_a_lag_bound_on_card(card):
    """widearea.capture's re-score: one pair, config3's needle against a
    guard-extended slice of its capture, the banded grid (2000 bins
    padded to whole bands, -inf past them), lags bounded at 100."""
    from caf_cookoff_tpu_torch.models._stein_plan import _plan_bands
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needle, hay, freqs, _, truth = bc.build_config3()
    plan = _plan_bands(FS, freqs)
    pad = torch.from_numpy(plan["freqs_pad"]).cuda()
    start = truth[0][1] - 64
    sl = torch.from_numpy(hay[:, start:start + 4096 + 128]).cuda()
    rng = np.random.default_rng(5)
    ranking = torch.from_numpy(rng.random((1, pad.shape[0])).astype(
        np.float32)).cuda()
    ranking[0, len(freqs):] = -np.inf
    ranking[0, int(np.argmin(np.abs(freqs - truth[0][0])))] = 2.0
    got = _assert_k5_matches_plain(
        torch.from_numpy(needle).cuda(), sl, pad, ranking, 8192, 4096,
        len(freqs), torch.tensor([100], device="cuda"))
    assert int(got.peak.lag_idx[0]) == 64
    assert float(pad[int(got.peak.freq_idx[0])]) == truth[0][0]


def test_rescore_exact_tie_goes_to_the_lowest_bin_on_card(card):
    """Two bins of one frequency give bit-identical rows: the tie goes to
    the lower bin, though the ranking puts the higher one first."""
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    n, h, _ = _golden(0, GOLDEN[0][1])
    freqs = torch.arange(60.0, 76.0, 1.0, device="cuda")
    freqs[12] = GOLDEN[0][2]                        # 69.25 Hz at bins 9, 12
    freqs[9] = GOLDEN[0][2]
    ranking = torch.arange(16, dtype=torch.float32, device="cuda")
    got = rs.rescore_kernel(n[None], h[None], freqs, ranking[None], FS, 8192,
                            4096)
    slots = got.cand[0].tolist()
    assert slots.index(12) < slots.index(9)
    assert float(got.vals[0, slots.index(12)]) == float(
        got.vals[0, slots.index(9)])
    assert int(got.peak.freq_idx[0]) == 9
    assert int(got.peak.lag_idx[0]) == GOLDEN[0][3]


def test_rescore_runs_on_each_card_of_a_process(card):
    """K5 on the first card and then on the second, in one process: the
    rows kernel's 64 KB of shared memory is granted on each card (its
    attributes are set at every launch), and both equal the plain chain
    on their own card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ns, hs, freqs, ranking = _k5_batch(4)
    for dev in ("cuda:0", "cuda:1"):
        on = [t.to(dev) for t in (ns, hs, freqs, ranking)]
        with torch.cuda.device(dev):
            got = _assert_k5_matches_plain(*on, 8192, 4096)
        assert got.peak.value.device == torch.device(dev)


def _k5_core(ns, hs, freqs, ranking, bound):
    from caf_cookoff_tpu_torch.models._stein_plan import _pack
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    return _pack(rs.stein_rescore(ns, hs, freqs, ranking, FS, 8192, 4096,
                                  lag_bound=bound))


def test_rescore_replay_is_its_eager_call_on_card(card):
    """K5 alone in a compiled call: the replay equals the eager call bit
    for bit, and each replay counts one call."""
    from caf_cookoff_tpu_torch.ops import _graph
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    ns, hs, freqs, ranking = _k5_batch(8)
    bound = torch.full((8,), 5000, dtype=torch.int64, device="cuda")
    traced = (ns, hs, freqs, ranking, bound)
    got, want = _replay_and_eager(_k5_core, traced, ())
    assert _same_bits(got, want)
    before = rs.RESCORE_LAUNCHES
    _graph.compiled(_k5_core, traced, ())
    assert rs.RESCORE_LAUNCHES == before + 1


def test_rescore_counts_one_call_a_search_on_card(card):
    """One K5 call a search of stein_caf_peak, batched_stein_peak and
    batched_stein_os_peak (replays), none in a StreamingCAF search."""
    from caf_cookoff_tpu_torch import (batched_stein_os_peak,
                                       batched_stein_peak, stein_caf_peak)
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    n, h, freqs = _golden(0, GOLDEN[0][1])
    ns, hs, grid, _ = _k5_batch(8)
    cn, ch, cf, lags = bc.build_config3(lags=16384)[:4]
    searches = [
        lambda: stein_caf_peak(n, h, freqs, FS, device="cuda"),
        lambda: batched_stein_peak(ns, hs, grid, FS, device="cuda"),
        lambda: batched_stein_os_peak(cn, ch, cf, FS, num_lags=lags,
                                      device="cuda")]
    for search in searches:
        search()
        before = rs.RESCORE_LAUNCHES
        for _ in range(3):
            search()
        assert rs.RESCORE_LAUNCHES == before + 3
    needle, hay, _, sfreqs = _stream3()
    _run_stream(needle, hay, sfreqs, backend="stein")[0].best()
    before = rs.RESCORE_LAUNCHES
    s, _ = _run_stream(needle, hay, sfreqs, backend="stein")
    s.best()
    assert rs.RESCORE_LAUNCHES == before
