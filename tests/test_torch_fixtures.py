"""Private chirp fixtures for the port's test files.

``tests/conftest.py``'s ``fixture_pairs`` writes the shared ``data/``
directory from every xdist worker that finds it incomplete, and
``synthesize_fixtures`` rewrites each ``.c64`` file in place
(``ndarray.tofile``): on a fresh tree one worker can read ``chirp_0``
while another truncates and rewrites it.  The port's test files import
``fixture_pairs`` and ``chirp`` from here instead, which override
conftest's: each test module gets its own copy, written by the port's
generator (byte-identical to the JAX package's,
``test_torch_config_io.py::test_generators_byte_identical``) into a
temporary directory, and the JAX functions in the same tests read the
same private files.
"""

import pathlib

import numpy as np
import pytest

from caf_cookoff_tpu_torch.utils.generate import (CHIRP_LENGTH, NUM_PAIRS,
                                                  synthesize_fixtures)
from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

REPO_DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


@pytest.fixture(scope="module")
def fixture_pairs(tmp_path_factory):
    """[(needle_path, haystack_path)] of the 10 reference chirps, written
    for this test module alone."""
    return synthesize_fixtures(tmp_path_factory.mktemp("fixtures"))


@pytest.fixture(scope="module")
def chirp(fixture_pairs):
    """chirp(i) -> (needle c64, truncated haystack c64, GroundTruth)."""

    def _load(idx: int):
        needle_path, haystack_path = fixture_pairs[idx]
        needle = load_c64(needle_path)
        haystack = load_c64(haystack_path, count=len(needle))
        return needle, haystack, parse_ground_truth(haystack_path)

    return _load


def test_private_fixtures_are_whole_and_private(fixture_pairs, chirp):
    assert len(fixture_pairs) == NUM_PAIRS
    for i, (needle_path, hay_path) in enumerate(fixture_pairs):
        assert pathlib.Path(needle_path).parent != REPO_DATA
        needle, hay, truth = chirp(i)
        assert needle.shape == hay.shape == (CHIRP_LENGTH,)
        assert len(load_c64(hay_path)) > CHIRP_LENGTH + truth.lag_samples
        assert np.all(np.isfinite(needle))
