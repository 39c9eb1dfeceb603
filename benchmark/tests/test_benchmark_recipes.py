"""The input recipes: the same seed gives the same inputs, every pool
item differs, and each truth lies inside the grid and the lags."""

import numpy as np
import pytest
import scipy.signal

from benchmark import cell as cells
from benchmark.recipes import chirp

SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5]


@pytest.mark.parametrize("name", ["cookoff.single", "widearea.capture",
                                  "cookoff.batch64"])
def test_deterministic_per_seed(name, small):
    config, workload = small(name)
    cell = cells.load(name, "cpu", config, workload)
    a, b = cells.make_pool(cell, 2 ** 31 + 99), cells.make_pool(cell,
                                                                2 ** 31 + 99)
    other = cells.make_pool(cell, 2 ** 31 + 100)
    for x, y, z in zip(a, b, other):
        for k in ("needles", "hays"):
            assert np.array_equal(x[k], y[k])
            assert not np.array_equal(x[k], z[k])
            assert x[k].dtype == np.complex64
        assert x["truths"] == y["truths"]
    assert not np.array_equal(a[0]["hays"], a[1]["hays"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cookoff.single", "widearea.capture"])
def test_truth_inside_grid_at_full_size(name, seed):
    cell = cells.load(name, "cpu", workload={"pool": 2})
    c = cell.config
    for item in cells.make_pool(cell, seed):
        assert item["needles"].shape == (1, c["needle_len"])
        hay_len = c.get("haystack_len", c["lags"] + c["needle_len"])
        assert item["hays"].shape == (1, hay_len)
        for freq, lag in item["truths"]:
            span = c["bins"] * c["freq_step_hz"]
            assert c["freq_start_hz"] <= freq < c["freq_start_hz"] + span
            assert 0 <= lag < c["lags"]
            if name.startswith("widearea"):
                assert freq in cell.freqs
                assert lag + c["needle_len"] <= hay_len


def test_cookoff_truth_is_the_recipe_range():
    cell = cells.load("cookoff.single", "cpu", workload={"pool": 8})
    for item in cells.make_pool(cell, 123):
        (offset, lag), = item["truths"]
        assert -100.0 <= offset < 100.0 and 7 <= lag < 256


@pytest.mark.parametrize("bw", [1e-3, 1e-2, 5e-2])
def test_numpy_filters_equal_scipy(bw):
    b = chirp.firwin(127, 0.5 * bw, 48000.0)
    np.testing.assert_allclose(
        b, scipy.signal.firwin(127, cutoff=0.5 * bw, fs=48000.0),
        rtol=0, atol=1e-15)
    x = np.random.default_rng(3).normal(size=(4096, 2)) @ [1, 1j]
    np.testing.assert_allclose(chirp.filtfilt(b, x),
                               scipy.signal.filtfilt(b, 1, x),
                               rtol=0, atol=1e-13)
