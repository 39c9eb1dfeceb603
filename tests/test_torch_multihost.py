"""The port's multi-process entry points against the JAX package's
``tests/test_multihost_{2proc,4proc,config5}.py``, on the CPU.

One gloo world of 4 ranks (one process a rank, each calling
``multihost.initialize_cluster()`` with the environment
``multihost.launch_local`` gives it, as ``torchrun`` would) runs every
case; the JAX engines run here on meshes of the same shapes.  The JAX
tests use 2 processes of 2 devices for their 4-device meshes; the port
has one device a process, so 4 ranks.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu import parallel as jpar
from caf_cookoff_tpu.parallel import multihost as jmh
from test_torch_parallel import (SNR_ATOL, Worlds, case, jax_mesh, run_jax,
                                 same_peak, same_rows)

torch.set_num_threads(1)

FS = 48e3


def _two_proc_input():
    """``test_multihost_2proc.py``'s pair: one emitter at -750 Hz, lag
    137."""
    n, lag, f_true = 512, 137, -750.0
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(n, np.complex64)
    hay[lag:] = (needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS))[: n - lag]
    return needle, hay, np.arange(-1000.0, 1000.0, 250.0, dtype=np.float32)


def _four_proc_input():
    """``test_multihost_4proc.py``'s capture: a tail-lag emitter, one
    straddling the 2nd/3rd chunk boundary, one inside chunk 0."""
    n, length = 256, 8192
    total_lags = length - n + 1
    chunk = max(-(-min(length, total_lags + n - 1) // 4), n - 1)
    truths = [(-500.0, 77, 1.0), (250.0, 2 * chunk - n // 2, 0.8),
              (500.0, total_lags - 1, 0.6)]
    rng = np.random.default_rng(7)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(length)
                   + 1j * rng.standard_normal(length))).astype(np.complex64)
    t = np.arange(n)
    for f_hz, lag, amp in truths:
        span = min(n, length - lag)
        hay[lag:lag + span] += (amp * needle * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)[:span]
    return needle, hay, np.arange(-1000.0, 1000.0, 250.0,
                                  dtype=np.float32), truths


def _config5_input():
    """``test_multihost_config5.py``'s batch: 4 pairs, one emitter each."""
    pairs, n, length = 4, 256, 8192
    lags = [100, 3000, 5555, 7936]
    f_true = [-500.0, 0.0, 250.0, 500.0]
    rng = np.random.default_rng(7)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, length))
                    + 1j * rng.standard_normal((pairs, length)))
            ).astype(np.complex64)
    t = np.arange(n)
    for b in range(pairs):
        span = min(n, length - lags[b])
        hays[b, lags[b]:lags[b] + span] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)[:span]
    return needles, hays, np.arange(-1000.0, 1000.0, 250.0,
                                    dtype=np.float32), f_true, lags


PUT_X = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)
PUT_SPECS = [(), ("doppler",), (("pair", "time"),), (None, ("pair", "time"))]


def _cases():
    needle, hay, freqs = _two_proc_input()
    c = [case("two_proc", 4, "multihost_caf_peak", needle, hay, freqs, FS,
              mesh={"doppler": 4}, backend="xla")]
    needle, hay, freqs, _ = _four_proc_input()
    t4 = {"time": 4}
    lat = dict(num_peaks=4, exclude_freq=2, exclude_lag=16, backend="xla")
    c += [case("four_proc_single", 4, "sharded_overlap_save_peak", needle,
               hay, freqs, FS, mesh=t4, backend="xla"),
          case("four_proc_lattice", 4, "sharded_overlap_save_peaks", needle,
               hay, freqs, FS, mesh=t4, **lat),
          case("four_proc_detect", 4, "sharded_overlap_save_peaks", needle,
               hay, freqs, FS, mesh=t4, min_snr_db=25.0, with_snr=True,
               **lat),
          case("four_proc_auto", 4, "sharded_overlap_save_peaks", needle,
               hay, freqs, FS, mesh=t4, min_snr_db="auto", **lat)]
    needles, hays, freqs, _, _ = _config5_input()
    c.append(case("config5", 4, "batched_overlap_save_peak", needles, hays,
                  freqs, FS, mesh={"pair": 2, "time": 2}, backend="xla"))
    for i, spec in enumerate(PUT_SPECS):
        c.append(case(f"put_{i}", 4, "put_global", PUT_X,
                      {"pair": 2, "time": 2}, spec, replicated=False))
    return c


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("world4"), _cases())
    yield w
    w.close()


def test_two_process_doppler_sharded_peak(world4):
    got = world4.get("two_proc")
    assert got[:2] == (-750.0, 137)
    needle, hay, freqs = _two_proc_input()
    want = jmh.multihost_caf_peak(needle, hay, freqs, FS,
                                  jax_mesh(doppler=4), backend="xla")
    same_peak(got, want)


def test_four_process_time_axis(world4):
    """Across 4 ranks on one time axis: the tail-lag and the straddling
    emitters, the lattice, and detection against the summed floor."""
    _, _, _, truths = _four_proc_input()
    single = world4.get("four_proc_single")
    assert single[:2] == truths[0][:2]
    same_peak(single, run_jax(world4.cases["four_proc_single"]))
    fr, lg, vv = world4.get("four_proc_lattice")
    rows = [(float(f), int(x)) for f, x, v in zip(fr, lg, vv)
            if np.isfinite(v)][:3]
    assert rows == [(f, lag) for f, lag, _ in truths]
    same_rows((fr, lg, vv), run_jax(world4.cases["four_proc_lattice"]))
    fr, lg, vv, snr = world4.get("four_proc_detect")
    assert int(np.isfinite(vv).sum()) == 3
    assert (snr[:3] > 25.0).all() and not np.isfinite(vv[3])
    want = run_jax(world4.cases["four_proc_detect"])
    same_rows((fr, lg, vv), want[:3])
    np.testing.assert_allclose(snr, want[3], atol=SNR_ATOL)
    vals_a = world4.get("four_proc_auto")[2]
    assert np.isfinite(vals_a[:3]).all()


def test_two_process_config5_pattern(world4):
    _, _, _, f_true, lags = _config5_input()
    got = world4.get("config5")
    assert list(got[0]) == f_true and list(got[1]) == lags
    same_rows(got, run_jax(world4.cases["config5"]))


@pytest.mark.parametrize("i", range(len(PUT_SPECS)))
def test_put_global_cuts_each_ranks_shard(world4, i):
    """``put_global`` gives each rank its JAX ``PartitionSpec`` shard of
    the host array; ``process_info`` and ``global_mesh`` name the
    world."""
    spec = PUT_SPECS[i]
    per_rank = world4.per_rank(f"put_{i}")
    for rank, (shard, info, gshape) in enumerate(per_rank):
        want = PUT_X
        for dim, axes in enumerate(spec):
            if axes == ("pair", "time"):
                size = PUT_X.shape[dim] // 4
                want = np.take(want, range(rank * size, (rank + 1) * size),
                               axis=dim)
            elif axes == "doppler":
                pass                            # doppler is 1 here
        np.testing.assert_array_equal(shard, want)
        assert info == f"process {rank}/4, backend gloo"
        assert gshape == (1, 4, 1)


def test_public_multihost_names():
    from caf_cookoff_tpu_torch.parallel import multihost as tmh

    for name in ("initialize_cluster", "global_mesh", "process_info",
                 "put_global", "multihost_caf_peak"):
        assert hasattr(tmh, name) and hasattr(jmh, name), name
    assert jpar.AXIS_TIME == "time"
