"""The port's scaling harness (``caf_cookoff_tpu_torch.utils.
bench_scaling``) on the CPU, at small shapes.

N = 1 runs in a world of one rank formed in this process (no process
start); N = 2 runs through the harness's own launcher, the file's one
world of processes (two ranks, each pinned to a core of its own).
Every point must pass its gate (chirp_0's golden answer, or the injected
truth) before it is timed.  Timings are only checked to be positive:
no test here asserts the sign of a difference of two timings.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from caf_cookoff_tpu_torch.parallel import multihost
from caf_cookoff_tpu_torch.utils import bench_scaling as bs

from test_torch_fixtures import fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

SMALL = {"doppler": {"grid": [60.0, 80.0, 0.25]},
         "time": {"n": 256, "total_lags": 4096, "num_bins": 16}}


@pytest.fixture(scope="module")
def data_dir(fixture_pairs):
    import pathlib

    return pathlib.Path(fixture_pairs[0][0]).parent


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of this process alone."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{multihost.free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(data_dir):
    """doppler and time at N = 2 through the harness's launcher."""
    return bs.run(["doppler", "time"], [2], "cpu", rounds=2, shapes=SMALL,
                  data_dir=data_dir, timeout=600)


@pytest.mark.parametrize("engine", ["doppler", "time"])
def test_point_at_one_rank(one_rank, data_dir, engine):
    out = bs.measure_point(engine, 1, "cpu", rounds=2,
                           shape=SMALL[engine], data_dir=data_dir)
    assert out["gate"] == "passed" and out["n"] == 1
    assert out["mode"] == "strong" and out["reduced"]
    for part in ("full", "compute"):
        assert out[part]["rounds"] == 2
        assert 0 < out[part]["best_ms"] <= out[part]["median_ms"]
    assert out["full_ms"] > 0 and out["compute_ms"] > 0
    assert out["collective_ms"] == out["full_ms"] - out["compute_ms"]


@pytest.mark.parametrize("engine", ["doppler", "time"])
def test_two_ranks_through_the_harness(two_ranks, engine):
    line = next(ln for ln in two_ranks if ln["engine"] == engine)
    assert line["n"] == 2 and line["gate"] == "passed"
    assert line["collectives"] == "gloo" and line["device"] == "cpu"
    assert len(set(line["pinned_cores"])) == 2
    assert line["mesh"][{"doppler": "doppler", "time": "time"}[engine]] == 2
    assert line["full_ms"] > 0 and line["compute_ms"] > 0
    assert "efficiency" not in line       # no N = 1 point in this run


def test_time_capture_is_bench_multiproc_s():
    """``_time_inputs`` at the full shape is ``bench_multiproc.py``'s
    ``_worker_time`` capture, byte for byte."""
    n, total_lags, k = 1024, 65_536, 64
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total_lags + n - 1) + 1j
                   * rng.standard_normal(total_lags + n - 1))
           ).astype(np.complex64)
    freqs_np = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    true_f, true_lag = float(freqs_np[k // 3]), total_lags - 1
    t = np.arange(n)
    hay[true_lag:true_lag + n] += (needle * np.exp(
        2j * np.pi * true_f * t / bs.FS)).astype(np.complex64)[: len(hay)
                                                               - true_lag]
    got = bs._time_inputs(bs.SHAPES["time"])
    for g, w in zip(got, (needle, hay, freqs_np)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[3] == (true_f, true_lag)


@pytest.mark.parametrize("engine", ["doppler", "time"])
def test_wrong_truth_is_refused_before_timing(one_rank, data_dir,
                                              monkeypatch, engine):
    if engine == "doppler":
        monkeypatch.setattr(bs, "DOPPLER_GATE", (69.25, 203))
    else:
        real = bs._time_inputs

        def shifted(shape):
            needle, hay, freqs, (f, lag) = real(shape)
            return needle, hay, freqs, (f, lag - 1)

        monkeypatch.setattr(bs, "_time_inputs", shifted)
    timed = []
    monkeypatch.setattr(bs, "_timed", lambda fn: timed.append(fn) or 1.0)
    with pytest.raises(bs.GateError, match=engine):
        bs.measure_point(engine, 1, "cpu", rounds=2, shape=SMALL[engine],
                         data_dir=data_dir)
    assert timed == []


def test_process_counts_are_refused_past_the_cores_and_on_the_card():
    cores = len(bs.usable_cores())
    with pytest.raises(ValueError, match="usable cores"):
        bs.run(["doppler"], [1, cores + 1], "cpu")
    bs.check_procs([1, cores], "cpu")
    with pytest.raises(ValueError, match="N = 1 only"):
        bs.check_procs([1, 2], "cuda")


def test_efficiencies_follow_bench_multiproc():
    rows = [{"n": 1, "mode": "strong", "full_ms": 8.0, "compute_ms": 6.0},
            {"n": 4, "mode": "strong", "full_ms": 4.0, "compute_ms": 2.0}]
    bs.efficiencies(rows)
    assert rows[1]["efficiency"] == 8.0 / (4 * 4.0)
    assert rows[1]["compute_efficiency"] == 6.0 / (4 * 2.0)
    weak = [{"n": 1, "mode": "weak", "full_ms": 5.0, "compute_ms": 4.0},
            {"n": 2, "mode": "weak", "full_ms": 10.0, "compute_ms": 5.0}]
    bs.efficiencies(weak)
    assert weak[1]["efficiency"] == 0.5 and weak[1]["compute_efficiency"] \
        == 0.8
    alone = [{"n": 2, "mode": "strong", "full_ms": 1.0, "compute_ms": 1.0}]
    bs.efficiencies(alone)
    assert "efficiency" not in alone[0]
