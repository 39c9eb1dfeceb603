"""The statistics, the trace's reductions and the frozen bound
arithmetic, on numbers worked out by hand."""

import numpy as np
import pytest

from benchmark import roofline, stats, window
from benchmark.trace import Trace

FS = 48000.0


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = list(rng.exponential(size=n))
        for q in (50, 95, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                np.percentile(xs, q), rel=1e-12)


def test_search_times_from_marks():
    # A stream: build, two chunks, best, then the search's own mark.
    durations = [("build", 1.0), ("chunk", 2.0), ("chunk", 3.0),
                 ("best", 0.5), ("search", 0.01),
                 ("build", 1.5), ("chunk", 2.5), ("chunk", 2.0),
                 ("best", 0.5), ("search", 0.02)]
    assert window.search_ms(durations) == pytest.approx([6.51, 6.52])
    assert window.step_ms(durations, "chunk") == [2.0, 3.0, 2.5, 2.0]
    assert window.search_ms([("search", 0.5), ("search", 0.7)]) == [0.5,
                                                                     0.7]


def test_window_mean_over_every_search():
    class Run:
        window_s, searches = 10.0, 4000
    from benchmark.metrics import search_ms
    assert search_ms.read(Run) == pytest.approx(2.5)


def test_union_gaps_and_idle_share():
    ivs = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.0, 12.0), (-1.0, 0.5)]
    assert stats.union(ivs, 0.0, 10.0) == [(0.0, 0.5), (1.0, 3.0),
                                            (5.0, 6.0), (9.0, 10.0)]
    busy = stats.union(ivs, 0.0, 10.0)
    assert stats.gaps(busy, 0.0, 10.0) == [(0.5, 1.0), (3.0, 5.0),
                                           (6.0, 9.0)]
    assert stats.idle_share(ivs, 0.0, 10.0) == pytest.approx(0.55)


def _trace():
    spans = {"search": [(0.0, 4.0), (4.0, 10.0)],
             "chunk": [(0.5, 2.0), (4.5, 9.0)]}
    ops = [("stein_tile", 1.0, 2.0), ("Memcpy HtoD", 2.0, 2.5),
           ("stein_tile", 5.0, 6.0), ("Memset", 8.0, 8.5),
           ("late", 11.0, 12.0)]
    return Trace(ops, [1.9, 3.9, 9.9, 10.5], spans)


def test_trace_reductions():
    tr = _trace()
    assert tr.window == (0.0, 10.0) and tr.searches == 2
    assert tr.busy_s == pytest.approx(3.0)
    assert len(tr.inside()) == 4 and len(tr.kernels()) == 2
    assert tr.syncs_inside() == 3
    assert tr.device_ops() == [["stein_tile", 2.0], ["Memcpy HtoD", 0.5],
                               ["Memset", 0.5]]
    # Idle gaps, each by the innermost step at its middle: [0, 1] chunk,
    # [2.5, 5] search, [6, 8] chunk, [8.5, 10] search.
    assert tr.idle_gaps() == [["search", pytest.approx(4.0)],
                              ["chunk", pytest.approx(3.0)]]


def test_idle_share_and_ops_readers():
    from benchmark.metrics import (device_ops_per_search, idle_share,
                                   kernel_roofline_share, syncs_per_search)

    class Run:
        trace = _trace()
        bound = {"least_s": 0.1}
    assert idle_share.read(Run) == pytest.approx(70.0)
    assert device_ops_per_search.read(Run) == 2.0
    assert syncs_per_search.read(Run) == 1.5
    # 0.1 s a search, two searches, 2 s of kernels.
    assert kernel_roofline_share.read(Run) == pytest.approx(10.0)


def _grid(start, step, bins):
    return (start + step * np.arange(bins)).astype(np.float32)


def _stein_bound_flops(lmat_shape, k, m, programs):
    """``chip_smoke.py``'s ``stein_bound_ms`` operation count from its
    operands' shapes: lmat (P, 2B, 2D), ws1 (K, 2B)."""
    _, b2, d2 = lmat_shape
    return programs * m * (2.0 * b2 * d2 + 2.0 * 2 * k * b2)


@pytest.mark.parametrize("case", ["config1", "config2", "config3",
                                  "stream3"])
def test_frozen_counts_equal_stein_bound(case):
    cookoff, wide = _grid(-100.0, 0.5, 400), _grid(-500.0, 0.5, 2000)
    if case in ("config1", "config2"):
        # One band, D = 64: lmat (P, 128, 128), ws1 (400, 128), M = 8192.
        pairs = 1 if case == "config1" else 64
        want = _stein_bound_flops((pairs, 128, 128), 400, 8192, pairs)
        got = roofline.search_bound(4096, 4096, cookoff, FS, 8192, pairs)
        assert roofline.routes(4096, cookoff, FS)["one_band"] * 8192 * \
            pairs == want
        assert got["flops"] == want and got["bound_by"] == "operations"
    elif case == "config3":
        # 6 bands of 375 bins at D = 128, 8 windows of 8192 lags: lmat
        # (6, 64, 256), ws1 (375, 64), 48 programs.
        want = _stein_bound_flops((6, 64, 256), 375, 8192, 48)
        got = roofline.search_bound(4096, 69632, wide, FS, 65536, 1)
        assert got["flops"] == want
    else:
        # A stream3 chunk: one band at D = 16, lmat (1, 512, 32), ws1
        # (2000, 512), 8192 lags.
        want = _stein_bound_flops((1, 512, 32), 2000, 8192, 1)
        assert roofline.routes(4096, wide, FS)["one_band"] * 8192 == want
        # The stream's search is bounded by the cheaper banded rank over
        # the capture's 69632 lags.
        got = roofline.search_bound(4096, 69632, wide, FS, 69632, 1)
        assert got["flops"] == roofline.routes(4096, wide, FS)[
            "bands"] * 69632 < 69632 / 8192 * want


def test_bytes_are_inputs_and_answers():
    grid = _grid(-100.0, 0.5, 400)
    got = roofline.search_bound(4096, 4096, grid, FS, 8192, 64)
    assert got["bytes"] == 64 * 8 * 8192 + 4 * 400 + 64 * 12
    assert got["least_s"] == pytest.approx(got["flops"] / 989e12)
