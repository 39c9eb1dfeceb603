"""Small sizes at which the CPU tests run the cells: the
configurations' rules, fewer samples, bins and lags."""

import pytest

def _chirp(**changes):
    from benchmark import spec
    return {**spec.load_json("configs", "cookoff")["chirp"], **changes}


SMALL = {
    # Lags as the full size's share of the needle (at most 1/16).
    "cookoff": {"needle_len": 512, "haystack_len": 512, "freq_step_hz": 5.0,
                "bins": 40, "lags": 1024, "chirp": _chirp(lag=[1, 32])},
    "widearea": {"needle_len": 512, "lags": 4096, "freq_step_hz": 5.0,
                 "bins": 200},
}
SMALL_WORKLOAD = {
    "cookoff.single": {"pool": 3},
    "widearea.capture": {"pool": 3},
    "widearea.stream": {"pool": 3, "chunk_len": 1024},
    "cookoff.batch64": {"pool": 3, "pairs_per_call": 4},
}
CELLS = list(SMALL_WORKLOAD)


@pytest.fixture
def small():
    """(config, workload) overrides of a cell at its small size."""
    def get(name):
        from benchmark import spec
        config = spec.load_json("workloads", name)["config"]
        return SMALL[config], SMALL_WORKLOAD[name]
    return get
