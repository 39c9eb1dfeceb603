"""The port's ``parallel/`` against the JAX package's, on the CPU.

Each JAX mesh test of ``tests/test_parallel.py`` has a counterpart here
at the same sizes.  The port's engines run in gloo worlds of 2, 4, 5 and
8 ranks (one process a rank, ``device="cpu"``), started once for this
module by :func:`start_worlds`: every rank runs every case of its world
size and writes its answers back, and the answers must be the same on
every rank.  The JAX engines run here on meshes of the same shapes over
conftest's 8 virtual CPU devices.  (freq, lag) must be identical,
values within rtol 1e-4 (the port's tolerance against JAX), lattices
row for row; where the JAX test pins its sharded engine BITWISE to its
single-device engine, the port's sharded engine is pinned bitwise to
the port's single-device engine (computed here, in this process).

The worker processes import torch and the port only: the worker is a
script written to a temporary directory and started with
``multihost.launch_local``, never a function of this module (that would
import JAX into them).
"""

import functools
import os
import pathlib
import pickle
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import caf_cookoff_tpu.parallel as jpar
from caf_cookoff_tpu.config import FreqGrid
from caf_cookoff_tpu.ops.peak import CafPeak as JPeak
from caf_cookoff_tpu.parallel import collectives as jcol
from caf_cookoff_tpu.parallel import mesh as jmesh
from caf_cookoff_tpu.parallel import sharded as jsh
import caf_cookoff_tpu_torch.parallel as tpar
from caf_cookoff_tpu_torch.errors import EligibilityError, SpanError
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import rate as trate
from caf_cookoff_tpu_torch.parallel import mesh as tmesh
from caf_cookoff_tpu_torch.parallel import multihost as tmh
from caf_cookoff_tpu_torch.parallel import sharded as tsh
from caf_cookoff_tpu_torch.utils.io import load_c64

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
FS = 48_000.0
GRID = FreqGrid(-100.0, 100.0, 0.25).frequencies(np.float32)
RTOL = 1e-4          # the port's value tolerance against JAX
SNR_ATOL = 1e-3      # dB: two values each within RTOL


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------

# Runs every case of its world size (argv: cases pickle, output pattern);
# rank 0 writes its answers, every rank a digest of them.
WORKER = textwrap.dedent('''
    import datetime, hashlib, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from caf_cookoff_tpu_torch.ops.peak import CafPeak
    from caf_cookoff_tpu_torch.parallel import (collectives, mesh as pmesh,
                                                multihost, sharded)

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, tuple):
            return tuple(host(v) for v in x)
        return x

    def tie_fuzz(world, vals, freqs, lags, axes, num_peaks, ef, el):
        mesh = pmesh.make_mesh(pair=2, doppler=2, time=2, device="cpu")
        r = dist.get_rank()
        local = CafPeak(torch.from_numpy(vals[r]),
                        torch.from_numpy(freqs[r]), torch.from_numpy(lags[r]))
        one = collectives.global_peak(local, axes, mesh=mesh)
        rate = collectives.global_rate_peak(
            local.value, local.freq_idx % 3, local.freq_idx, local.lag_idx,
            axes, mesh=mesh)
        lat = collectives.global_peaks(local, axes, num_peaks, ef, el,
                                       mesh=mesh)
        bat = collectives.global_peaks_batched(
            CafPeak(*(x.reshape(2, -1) for x in local)), axes, num_peaks, ef,
            el, mesh=mesh)
        return tuple(one), tuple(rate), tuple(lat), tuple(bat)

    def mesh_errors(world):
        out = []
        for kw in ({"pair": 3}, {"doppler": world, "time": 2}):
            try:
                pmesh.make_mesh(device="cpu", **kw)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        for kw in ({"device": "cpu", "collectives": "nccl"},
                   {"device": "cpu", "collectives": "mpi"}):
            try:
                pmesh.make_mesh(doppler=world, **kw)
                out.append(None)
            except ValueError as e:
                out.append(type(e).__name__)
        return tuple(out)

    def mesh_layout(world, shape, axes):
        mesh = pmesh.make_mesh(device="cpu", **shape)
        coords = mesh.coords
        got = collectives.all_gather(torch.tensor([dist.get_rank()]), axes,
                                     mesh=mesh).reshape(-1)
        return (tuple(coords[a] for a in pmesh.ALL_AXES), host(got),
                mesh.flat_index(axes))

    def put_global(world, x, shape, spec):
        mesh = pmesh.make_mesh(device="cpu", **shape)
        return (host(multihost.put_global(x, mesh, spec)),
                multihost.process_info(),
                tuple(multihost.global_mesh(device="cpu").shape.values()))

    SPECIAL = {"tie_fuzz": tie_fuzz, "mesh_errors": mesh_errors,
               "mesh_layout": mesh_layout, "put_global": put_global}

    def main():
        cases_path, out_pattern = sys.argv[1:3]
        multihost.initialize_cluster(
            backend="gloo", timeout=datetime.timedelta(seconds=240))
        world, rank = dist.get_world_size(), dist.get_rank()
        with open(cases_path, "rb") as f:
            cases = [c for c in pickle.load(f) if c["world"] == world]
        out = {}
        for c in cases:
            try:
                if c["fn"] in SPECIAL:
                    res = SPECIAL[c["fn"]](world, *c["args"], **c["kwargs"])
                else:
                    mesh = pmesh.make_mesh(device="cpu", **c["mesh"])
                    fn = getattr(sharded, c["fn"], None) or getattr(
                        multihost, c["fn"])
                    res = fn(*c["args"], mesh=mesh, **c["kwargs"])
                res = ("ok", host(res))
            except Exception as e:                 # reported per case
                res = ("raised", type(e).__name__, str(e))
            blob = pickle.dumps(res)
            out[c["name"]] = (hashlib.sha256(blob).hexdigest(),
                              res if rank == 0 or not c["replicated"]
                              else None)
        with open(out_pattern % rank, "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()

    main()
''')


def case(name, world, fn, *args, mesh=None, replicated=True, **kwargs):
    """One engine call in every rank of a world of ``world`` ranks;
    ``replicated=False``: the ranks' answers differ by design."""
    return {"name": name, "world": world, "fn": fn, "args": args,
            "kwargs": kwargs, "mesh": mesh or {}, "replicated": replicated}


class Worlds:
    """The gloo worlds of one test module, started together."""

    def __init__(self, tmp: pathlib.Path, cases, timeout: float = 600.0):
        self.cases = {c["name"]: c for c in cases}
        assert len(self.cases) == len(cases), "duplicate case names"
        (tmp / "worker.py").write_text(WORKER)
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        self.tmp = tmp
        self.timeout = timeout
        env = dict(os.environ, PYTHONPATH=f"{REPO_ROOT}:"
                   f"{os.environ.get('PYTHONPATH', '')}")
        self.procs = {}
        for world in sorted({c["world"] for c in cases}):
            pattern = str(tmp / f"w{world}_r%d.pkl")
            self.procs[world] = (pattern, tmh.launch_local(
                [sys.executable, str(tmp / "worker.py"),
                 str(tmp / "cases.pkl"), pattern], world, env=env))
        self.results = {}

    def _finish(self, world):
        if world in self.results:
            return
        pattern, procs = self.procs[world]
        outs = tmh.wait_local(procs, self.timeout)
        for rank, (rc, text) in enumerate(outs):
            assert rc == 0, f"world {world} rank {rank} failed:\n{text[-3000:]}"
        ranks = []
        for rank in range(world):
            with open(pattern % rank, "rb") as f:
                ranks.append(pickle.load(f))
        self.results[world] = ranks

    def get(self, name):
        """Rank 0's answer to case ``name``, after checking every rank
        gave the same; an exception raised by the engine re-raises."""
        world = self.cases[name]["world"]
        self._finish(world)
        ranks = self.results[world]
        digests = {r[name][0] for r in ranks}
        if self.cases[name]["replicated"]:
            assert len(digests) == 1, f"{name}: ranks disagree"
        res = ranks[0][name][1]
        if res[0] == "raised":
            raise RuntimeError(f"{name} raised {res[1]}: {res[2]}")
        return res[1]

    def per_rank(self, name):
        """Every rank's answer to a case whose answers differ by rank."""
        world = self.cases[name]["world"]
        self._finish(world)
        out = []
        for r in self.results[world]:
            res = r[name][1]
            if res[0] == "raised":
                raise RuntimeError(f"{name} raised {res[1]}: {res[2]}")
            out.append(res[1])
        return out

    def close(self):
        for world, (_, procs) in self.procs.items():
            if world not in self.results:
                try:
                    tmh.wait_local(procs, 0.0)
                except TimeoutError:
                    pass


def jax_mesh(pair=1, doppler=1, time=1):
    n = pair * doppler * time
    return jmesh.make_mesh(pair=pair, doppler=doppler, time=time,
                           devices=jax.devices()[:n])


def run_jax(c):
    """JAX's sharded engine on the case's inputs and mesh shape."""
    fn = getattr(jpar, c["fn"], None) or getattr(jsh, c["fn"])
    return fn(*c["args"], mesh=jax_mesh(**c["mesh"]), **c["kwargs"])


def same_peak(got, want):
    """(freq, lag[, ...]) identical, the value within RTOL."""
    got, want = tuple(got), tuple(want)
    assert got[:-1] == tuple(type(g)(w) for g, w in zip(got[:-1],
                                                         want[:-1])), \
        (got, want)
    assert got[-1] == pytest.approx(float(want[-1]), rel=RTOL)


def same_rows(got, want, n_int=2):
    """Array outputs: the first ``n_int`` fields (freqs or rates and
    freqs, lags) equal, then the values within RTOL and the SNRs within
    SNR_ATOL dB; -inf slots exactly where JAX has them."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if i < n_int:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=i)
            continue
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=i)
        tol = dict(rtol=RTOL) if i == n_int else dict(atol=SNR_ATOL)
        np.testing.assert_allclose(g[fin], w[fin], err_msg=i, **tol)


def bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# Inputs (the JAX tests' recipes)
# ---------------------------------------------------------------------------


def _cx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _synthetic_long():
    rng = np.random.default_rng(5)
    n, length, lag, f_true = 512, 65536, 51_200, -1500.0
    needle = _cx(rng, n)
    hay = _cx(rng, length, 1e-4)
    hay[lag:lag + n] += needle * np.exp(
        2j * np.pi * f_true * np.arange(n) / FS).astype(np.complex64)
    return needle, hay, np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)


def _three_axes():
    rng = np.random.default_rng(9)
    pairs, n, length = 4, 512, 16384
    lags = [700, 5001, 9800, 15872]
    f_true = [-750.0, 0.0, 250.0, 500.0]
    needles = _cx(rng, (pairs, n))
    hays = _cx(rng, (pairs, length), 1e-4)
    t = np.arange(n)
    for b in range(pairs):
        span = min(n, length - lags[b])
        hays[b, lags[b]:lags[b] + span] += (
            needles[b] * np.exp(2j * np.pi * f_true[b] * t / FS)
        ).astype(np.complex64)[:span]
    return needles, hays, np.arange(-1000.0, 1000.0, 250.0,
                                    dtype=np.float32), f_true, lags


def _tail_lag():
    rng = np.random.default_rng(11)
    n, length = 512, 65536
    lag = length - n
    needle = _cx(rng, n)
    hay = _cx(rng, length, 1e-4)
    hay[lag:] += needle
    return needle, hay, np.arange(-500.0, 500.0, 125.0, dtype=np.float32), lag


def _near_tie():
    n = 4096
    freqs = np.arange(-180.0, 180.1, 12.0, dtype=np.float32)
    t = np.arange(n)
    rng = np.random.default_rng(0)
    needle = _cx(rng, n)
    needle /= np.abs(needle).max()
    hay = np.zeros(n, np.complex64)
    comp = needle * np.exp(2j * np.pi * 168.0 * t / FS) + 0.955 * needle
    hay[64:] = comp[:n - 64].astype(np.complex64)
    return needle, hay, freqs


FUZZ_CASES = [
    (20, 1024, 1024, 0, 1, -300.0, 75.0, 8, 8, 1),
    (21, 2048, 2048, 1500, 6, -100.0, 12.5, 16, 2, 1),
    (22, 512, 24576, 24064, 4, -500.0, 125.0, 8, 2, 4),
    (23, 1000, 17000, 9871, 2, -750.0, 250.0, 6, 4, 2),
]


def _fuzz_input(seed, n, total, lag, f_idx, g0, gs, gk):
    rng = np.random.default_rng(seed)
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    needle = _cx(rng, n)
    hay = _cx(rng, total, 1e-4)
    span = min(n, total - lag)
    hay[lag:lag + span] += (needle * np.exp(
        2j * np.pi * float(freqs[f_idx]) * np.arange(n) / FS)
    ).astype(np.complex64)[:span]
    return needle, hay, freqs


def _swept(emitters, n=2048, length=16384, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    needle = _cx(rng, n)
    t_sec = np.arange(n) / FS
    hay = _cx(rng, length, noise)
    for f0, rate, lag, amp in emitters:
        cp = amp * needle * np.exp(2j * np.pi * f0 * t_sec
                                   + 1j * np.pi * rate * t_sec ** 2)
        hay[lag:lag + n] += cp.astype(np.complex64)
    return needle, hay


RATE_EMITTERS = [(20.0, 400.0, 4500, 1.0), (-31.0, -200.0, 900, 0.8)]
RATE_FREQS = np.arange(-60, 60, 0.5, dtype=np.float32)
RATE_GRID_R = np.arange(-600.0, 601.0, 200.0)
RATE_SHAPES = [(2, 1), (1, 4), (2, 4)]


def _stein_os_cases():
    rng = np.random.default_rng(5)
    n, total = 2048, 32768
    nd = _cx(rng, n)
    base = _cx(rng, total, 1e-4)
    t = np.arange(n)
    out = []
    for freqs, f_inj, lag in [
            (np.arange(-100, 100, 0.5, dtype=np.float32), -42.0, 9000),
            (np.linspace(-500, 500, 256, endpoint=False).astype(np.float32),
             None, 21000),
            # The FINAL full-overlap lag: the last shard's windows must
            # read the capture's end, not a clamped slice.
            (np.arange(-100, 100, 0.5, dtype=np.float32), 33.0,
             total - 2048)]:
        f_inj = float(freqs[181]) if f_inj is None else f_inj
        hay = base.copy()
        hay[lag:lag + n] += (nd * np.exp(
            2j * np.pi * f_inj * t / FS)).astype(np.complex64)
        out.append((nd, hay, freqs, f_inj, lag))
    return out


def _rate_pair_axis():
    rng = np.random.default_rng(12)
    n, total = 1024, 8192
    nd = _cx(rng, n)
    hay = _cx(rng, total, 1e-4)
    t = np.arange(n)
    ph = 2 * np.pi * 40.0 * t / FS + np.pi * 3000.0 * (t / FS) ** 2
    hay[5000:5000 + n] += (nd * np.exp(1j * ph)).astype(np.complex64)
    return (nd, hay, np.arange(-100.0, 100.0, 25.0, dtype=np.float32),
            np.arange(-6000.0, 6001.0, 3000.0))


def _fused_lattice():
    rng = np.random.default_rng(5)
    n, total, batch = 1024, 16384, 4
    t = np.arange(n)
    nds, hays = [], []
    for b in range(batch):
        nd = _cx(rng, n)
        hay = _cx(rng, total, 1e-4)
        for f, lag, amp in ((-30.0 + b, 3000 + 100 * b, 1.0),
                            (45.0 - b, 9000 + 50 * b, 0.7)):
            hay[lag:lag + n] += (amp * nd * np.exp(
                2j * np.pi * f * t / FS)).astype(np.complex64)
        nds.append(nd)
        hays.append(hay)
    return np.stack(nds), np.stack(hays)


FUSED_GRIDS = [np.arange(-100, 100, 0.5, dtype=np.float32),
               np.linspace(-500, 500, 256, endpoint=False).astype(np.float32)]


def _segmented_rate():
    rng = np.random.default_rng(8)
    n, total = 2048, 16384
    needle = _cx(rng, n)
    t = np.arange(n)

    def mk(f0, r_true, lag, seed):
        r2 = np.random.default_rng(seed)
        hay = _cx(r2, total, 1e-4)
        ph = 2 * np.pi * f0 * t / FS + np.pi * r_true * (t / FS) ** 2
        hay[lag:lag + n] += (needle * np.exp(1j * ph)).astype(np.complex64)
        return hay

    rates = np.arange(-240.0, 241.0, 60.0, dtype=np.float32)
    freqs_w = np.linspace(-500, 500, 400, endpoint=False).astype(np.float32)
    return (needle, rates, np.arange(-100, 100, 0.5, dtype=np.float32),
            mk(25.0, 120.0, total - n, 1), freqs_w,
            mk(float(freqs_w[317]), -180.0, 7000, 2))


def _tie_inputs(seed, shape=(8, 4)):
    """Per-rank candidate rows with ties planted across ranks: equal
    values at different (freq, lag), and exact duplicates."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.float32([1.0, 2.0, 3.0]), size=shape)
    freqs = rng.integers(0, 6, size=shape).astype(np.int32)
    lags = rng.integers(0, 40, size=shape).astype(np.int32)
    top = rng.choice(shape[0], size=3, replace=False)
    vals[top, 0] = 7.0                       # the max on three ranks
    freqs[top[1], 0] = freqs[top[0], 0]      # two with the same freq
    return vals, freqs, lags


TIE_AXES = ["doppler", ("doppler", "time"), ("pair", "doppler", "time")]


def _all_cases(fixture_pairs):
    c = []
    needle0 = load_c64(fixture_pairs[0][0])
    hay0 = load_c64(fixture_pairs[0][1], count=len(needle0))
    full0 = load_c64(fixture_pairs[0][1])
    for d in (2, 8):
        c.append(case(f"surface_d{d}", d, "sharded_caf_surface", needle0,
                      hay0, GRID, FS, mesh={"doppler": d}))
    for d in (2, 5, 8):
        c.append(case(f"peak_d{d}", d, "sharded_caf_peak", needle0, hay0,
                      GRID, FS, mesh={"doppler": d}))
    for backend in PALLAS:
        c.append(case(f"peak_{backend}", 2, "sharded_caf_peak", needle0,
                      hay0, GRID[660:700], FS, mesh={"doppler": 2},
                      backend=backend))
    c.append(case("surface_pallas", 2, "sharded_caf_surface", needle0, hay0,
                  GRID[660:700], FS, mesh={"doppler": 2}, backend="pallas"))
    chirps = {}
    for i in (0, 2, 3, 5, 7):
        n = load_c64(fixture_pairs[i][0])
        chirps[i] = (n, load_c64(fixture_pairs[i][1], count=len(n)))
    idxs = [0, 3, 5, 7]
    ns = np.stack([chirps[i][0] for i in idxs])
    hs = np.stack([chirps[i][1] for i in idxs])
    c.append(case("batched_pd", 8, "batched_caf_peak", ns, hs, GRID, FS,
                  mesh={"pair": 2, "doppler": 4}))
    for d, t in ((1, 8), (4, 2), (2, 2)):
        c.append(case(f"os_d{d}_t{t}", d * t, "sharded_overlap_save_peak",
                      needle0, full0, GRID, FS,
                      mesh={"doppler": d, "time": t}))
    needle, hay, freqs = _synthetic_long()
    c.append(case("os_synthetic_long", 8, "sharded_overlap_save_peak",
                  needle, hay, freqs, FS, mesh={"doppler": 2, "time": 4}))
    needles, hays, freqs, _, _ = _three_axes()
    c.append(case("os_three_axes", 8, "batched_overlap_save_peak", needles,
                  hays, freqs, FS, mesh={"pair": 2, "doppler": 2, "time": 2},
                  backend="xla"))
    needle, hay, freqs, _ = _tail_lag()
    c.append(case("os_tail_lag", 4, "sharded_overlap_save_peak", needle, hay,
                  freqs, FS, mesh={"time": 4}))
    n2, h2 = chirps[2]
    fine = FreqGrid(30.0, 35.0, 0.05).frequencies(np.float32)
    for name, d in (("determinism_a", 8), ("determinism_b", 8),
                    ("determinism_c", 4)):
        c.append(case(name, d, "sharded_caf_peak", n2, h2, fine, FS,
                      mesh={"doppler": d}))
    for d in (4, 8):
        c.append(case(f"stein_d{d}", d, "sharded_stein_peak", needle0, hay0,
                      GRID, FS, mesh={"doppler": d}))
    needle, hay, freqs = _near_tie()
    for refine in (False, True):
        c.append(case(f"stein_near_tie_{refine}", 8, "sharded_stein_peak",
                      needle, hay, freqs, FS, mesh={"doppler": 8},
                      refine=refine))
    c.append(case("stein_chirp3", 8, "sharded_stein_peak", *chirps[3], GRID,
                  FS, mesh={"doppler": 8}))
    c.append(case("batched_stein_pairs", 4, "sharded_batched_stein_peak", ns,
                  hs, GRID, FS, mesh={"pair": 4}))
    for seed, n, total, lag, f_idx, g0, gs, gk, d, t in FUZZ_CASES:
        needle, hay, freqs = _fuzz_input(seed, n, total, lag, f_idx, g0, gs,
                                         gk)
        if total == n:
            c.append(case(f"fuzz{seed}_fb", d, "sharded_caf_peak", needle,
                          hay, freqs, FS, mesh={"doppler": d}))
            c.append(case(f"fuzz{seed}_stein", d, "sharded_stein_peak",
                          needle, hay, freqs, FS, mesh={"doppler": d}))
        else:
            c.append(case(f"fuzz{seed}_os", d * t,
                          "sharded_overlap_save_peak", needle, hay, freqs,
                          FS, mesh={"doppler": d, "time": t}))
    needle, hay = _swept(RATE_EMITTERS)
    for d, t in RATE_SHAPES:
        mesh = {"doppler": d, "time": t}
        c.append(case(f"rate_peak_{d}_{t}", d * t,
                      "sharded_rate_overlap_save_peak", needle, hay,
                      RATE_FREQS, RATE_GRID_R, FS, mesh=mesh, backend="xla"))
        c.append(case(f"rate_lattice_{d}_{t}", d * t,
                      "sharded_rate_overlap_save_peaks", needle, hay,
                      RATE_FREQS, RATE_GRID_R, FS, mesh=mesh, num_peaks=3,
                      backend="xla", with_snr=True))
    noise_n, noise_h = _swept([], noise=1.0)
    c.append(case("rate_noise", 4, "sharded_rate_overlap_save_peaks",
                  noise_n, noise_h, RATE_FREQS, RATE_GRID_R, FS,
                  mesh={"doppler": 2, "time": 2}, num_peaks=3, backend="xla",
                  min_snr_db="auto"))
    dt = {"doppler": 2, "time": 2}
    c += [case("p1_os", 4, "sharded_overlap_save_peak", needle, hay,
               RATE_FREQS, FS, mesh=dt, backend="xla"),
          case("p1_os_peaks", 4, "sharded_overlap_save_peaks", needle, hay,
               RATE_FREQS, FS, mesh=dt, num_peaks=1, backend="xla"),
          case("p1_rate", 4, "sharded_rate_overlap_save_peak", needle, hay,
               RATE_FREQS, RATE_GRID_R, FS, mesh=dt, backend="xla"),
          case("p1_rate_peaks", 4, "sharded_rate_overlap_save_peaks", needle,
               hay, RATE_FREQS, RATE_GRID_R, FS, mesh=dt, num_peaks=1,
               backend="xla"),
          case("p1_batched", 8, "batched_overlap_save_peak",
               np.stack([needle, needle]), np.stack([hay, hay]), RATE_FREQS,
               FS, mesh={"pair": 2, "doppler": 2, "time": 2}, backend="xla"),
          case("p1_batched_peaks", 8, "batched_overlap_save_peaks",
               np.stack([needle, needle]), np.stack([hay, hay]), RATE_FREQS,
               FS, mesh={"pair": 2, "doppler": 2, "time": 2}, num_peaks=1,
               backend="xla")]
    for i, (nd, hay, freqs, _, _) in enumerate(_stein_os_cases()):
        for t in (2, 4):
            c.append(case(f"stein_os_{i}_t{t}", t, "sharded_stein_os_peak",
                          nd, hay, freqs, FS, mesh={"time": t}))
    nd, hay, freqs, rates = _rate_pair_axis()
    for shape in ({"pair": 2, "time": 2}, {"pair": 2, "doppler": 2},
                  {"pair": 4}):
        tag = "_".join(f"{k}{v}" for k, v in shape.items())
        c.append(case(f"rate_pair_{tag}", 4, "sharded_rate_overlap_save_peak",
                      nd, hay, freqs, rates, FS, mesh=shape, backend="xla"))
    c.append(case("rate_pair_lattice", 4, "sharded_rate_overlap_save_peaks",
                  nd, hay, freqs, rates, FS, mesh={"pair": 2, "time": 2},
                  num_peaks=2, backend="xla", with_snr=True))
    nds, hays = _fused_lattice()
    for g, freqs in enumerate(FUSED_GRIDS):
        c.append(case(f"fused_pairs_{g}", 2, "sharded_batched_stein_os_peaks",
                      nds, hays, freqs, FS, mesh={"pair": 2}, num_peaks=3))
        for t in (2, 4):
            c.append(case(f"fused_time_{g}_t{t}", t,
                          "sharded_stein_os_peaks", nds[0], hays[0], freqs,
                          FS, mesh={"time": t}, num_peaks=3))
    needle, rates, freqs, hay, freqs_w, hay2 = _segmented_rate()
    for t in (2, 4):
        c.append(case(f"seg_rate_t{t}", t, "sharded_stein_rate_os_peak",
                      needle, hay, freqs, rates, FS, mesh={"time": t}))
    c.append(case("seg_rate_banded_t4", 4, "sharded_stein_rate_os_peak",
                  needle, hay2, freqs_w, rates, FS, mesh={"time": 4}))
    for seed in range(4):
        for a, axes in enumerate(TIE_AXES):
            c.append(case(f"tie_{seed}_{a}", 8, "tie_fuzz",
                          *_tie_inputs(seed), axes, 4, 1, 5,
                          replicated=False))
    c.append(case("mesh_errors_8", 8, "mesh_errors"))
    c.append(case("layout_dt", 8, "mesh_layout", {"pair": 2, "doppler": 2,
                                                  "time": 2},
                  ("doppler", "time"), replicated=False))
    c.append(case("layout_pt", 8, "mesh_layout", {"pair": 2, "doppler": 2,
                                                  "time": 2},
                  ("pair", "time"), replicated=False))
    return c


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, fixture_pairs):
    w = Worlds(tmp_path_factory.mktemp("worlds"), _all_cases(fixture_pairs))
    yield w
    w.close()


# ---------------------------------------------------------------------------
# Host-side pieces
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh():
    """A gloo world of this process alone, and its mesh."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{tmh.free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        yield tmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# Past the single-band envelope at 48 kHz and not uniform, so no band
# plan either: neither windowed route takes it.
OFF_ROUTE = np.asarray([0.0, 23000.0, 23001.5], np.float32)


@pytest.mark.parametrize("engine,error,match", [
    ("batched_stein_os_peak", SpanError, "does not pay off"),
    ("batched_stein_os_peaks", EligibilityError,
     "neither fits .* use batched_overlap_save_peaks_local"),
    ("sharded_stein_os_peak", EligibilityError,
     "neither fits .* use sharded_overlap_save_peak for it"),
])
def test_windowed_engines_raise_their_own_error_off_both_routes(
        request, engine, error, match):
    """Each windowed engine raises its own typed error on a grid neither
    route takes (``stein_rate_os_peak``'s ``SpanError`` is pinned in
    ``test_torch_rate.py``); ``sharded_stein_os_peak`` at one gloo
    rank."""
    rng = np.random.default_rng(3)
    nd, hay = _cx(rng, 256), _cx(rng, 2048)
    if engine.startswith("sharded"):
        mesh = request.getfixturevalue("one_rank_mesh")
        call = functools.partial(tsh.sharded_stein_os_peak, nd, hay,
                                 OFF_ROUTE, FS, mesh)
    else:
        call = functools.partial(
            getattr(tbs, engine), nd[None], hay[None], OFF_ROUTE, FS,
            *((2,) if engine.endswith("peaks") else ()), device="cpu")
    with pytest.raises(error, match=match):
        call()


def test_factor_devices_matches_jax():
    for n in range(1, 65):
        for axes in (1, 2, 3, 4):
            assert tmesh.factor_devices(n, axes) == \
                jmesh.factor_devices(n, axes)
    with pytest.raises(ValueError):
        tmesh.factor_devices(0, 3)


def test_estimate_hbm_per_chip_matches_jax():
    for args in [(256, 4096, 4096, 262144), (8, 64, 1024, 16384),
                 (3, 801, 777, 65537), (1, 1, 8, 9)]:
        for shape in [(1, 1, 1), (32, 8, 1), (2, 2, 2), (4, 1, 4),
                      (3, 5, 7)]:
            kw = dict(zip(("pair", "doppler", "time"), shape))
            assert tpar.estimate_hbm_per_chip(*args, **kw) == \
                jpar.estimate_hbm_per_chip(*args, **kw)
    est = tpar.estimate_hbm_per_chip(256, 4096, 4096, 262144, pair=32,
                                     doppler=8)
    assert est["needle_spectra_mb"] == 256.0


def test_public_names_match_jax():
    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, n) for n in tpar.__all__)


def test_pad_axis_to_matches_jax():
    rng = np.random.default_rng(0)
    for size in (1, 5, 8, 801):
        x = rng.standard_normal((size, 3)).astype(np.float32)
        for mult in (1, 2, 5, 8):
            np.testing.assert_array_equal(tsh.pad_axis_to(x, mult),
                                          jsh.pad_axis_to(x, mult))


def test_mesh_needs_a_process_group_and_nccl_a_card():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_cluster"):
        tmesh.make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.mesh_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmh.initialize_cluster("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="unknown backend"):
        tmh.initialize_cluster("127.0.0.1:1", 1, 0, backend="mpi")


def test_deferred_halo_matches_jax_and_plain_scan():
    """The port's deferred-halo scan: single peak bitwise equal to its
    own plain scan over cat([local, halo]) and (freq, lag) equal to
    JAX's, lattices and floors too, for chunks hitting every
    interior/boundary split (including chunk < d)."""
    import jax.numpy as jnp

    from caf_cookoff_tpu.models import overlap_save as jos
    from caf_cookoff_tpu.ops import splitfft
    from caf_cookoff_tpu_torch.models import overlap_save as tos

    n = 256
    rng = np.random.default_rng(21)
    needle = _cx(rng, n)
    freqs = np.arange(-100, 100, 10.0, dtype=np.float32)
    total = 8192
    hay = _cx(rng, total, 1e-4)
    t = np.arange(n)
    for f, lag, amp in ((-30.0, 700, 1.0), (40.0, 3000, 0.6)):
        hay[lag:lag + n] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)
    n_sp = tuple(jnp.asarray(p) for p in splitfft.split_array(needle))
    h_sp = splitfft.split_array(hay)
    nt, ht = torch.from_numpy(needle), torch.from_numpy(hay)
    halo = n - 1
    for chunk in (4096, 3500, 200):
        m, _, _ = jos.plan_blocks(n, chunk)
        js = jos.needle_spectra_conj(n_sp, jnp.asarray(freqs), FS, m, "xla")
        ts = tos.needle_spectra_conj(nt, torch.from_numpy(freqs), FS, m)
        jl = tuple(jnp.asarray(p[:chunk]) for p in h_sp)
        jh = tuple(jnp.asarray(p[chunk:chunk + halo]) for p in h_sp)
        tl, th = ht[:chunk], ht[chunk:chunk + halo]
        want = jsh.streaming_peak_deferred_halo(js, jl, jh, n, chunk, 0,
                                                None, "xla")
        got = tsh.streaming_peak_deferred_halo(ts, tl, th, n, chunk, 0,
                                               None, "xla")
        plain = tos.streaming_peak(ts, torch.cat([tl, th]), n, chunk)
        assert (int(got.freq_idx), int(got.lag_idx)) == \
            (int(want.freq_idx), int(want.lag_idx)), chunk
        assert float(got.value) == pytest.approx(float(want.value), rel=RTOL)
        bitwise(got, plain)
        kw = dict(num_peaks=3, exclude_freq=2, exclude_lag=64,
                  with_floor=True)
        want_l, ws, wc = jsh.streaming_peak_deferred_halo(
            js, jl, jh, n, chunk, 0, None, "xla", **kw)
        got_l, gs, gc = tsh.streaming_peak_deferred_halo(
            ts, tl, th, n, chunk, 0, None, "xla", **kw)
        assert float(gc) == float(wc), chunk
        assert float(gs) == pytest.approx(float(ws), rel=RTOL)
        fin = np.isfinite(np.asarray(want_l.value))
        for g, w in zip(got_l[1:], want_l[1:]):
            np.testing.assert_array_equal(np.asarray(g)[fin],
                                          np.asarray(w)[fin])
        np.testing.assert_allclose(np.asarray(got_l.value)[fin],
                                   np.asarray(want_l.value)[fin], rtol=RTOL)


def test_parallel_imports_neither_jax_nor_the_jax_package():
    import subprocess

    src = REPO_ROOT / "caf_cookoff_tpu_torch" / "parallel"
    for path in src.glob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert not any(w in text for w in ("from caf_cookoff_tpu.",
                                           "import caf_cookoff_tpu.",
                                           "from caf_cookoff_tpu import")), \
            path
    code = ("import sys, caf_cookoff_tpu_torch.parallel, "
            "caf_cookoff_tpu_torch.parallel.multihost; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'caf_cookoff_tpu.')) or "
            "m == 'caf_cookoff_tpu']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# Meshes and collectives
# ---------------------------------------------------------------------------


def test_mesh_size_mismatch_raises_with_jax_text(worlds):
    got = worlds.get("mesh_errors_8")
    for kw, text in zip(({"pair": 3}, {"doppler": 8, "time": 2}), got):
        with pytest.raises(ValueError) as e:
            jmesh.make_mesh(devices=jax.devices()[:8], **kw)
        assert text == str(e.value)
    assert got[2:] == ("ValueError", "ValueError")


@pytest.mark.parametrize("tag,axes,order", [
    ("dt", ("doppler", "time"), [0, 1, 2, 3]),
    ("pt", ("pair", "time"), [0, 1, 4, 5])])
def test_mesh_layout_is_row_major(worlds, tag, axes, order):
    """Rank 0 sits at (0, 0, 0), and a group over ``axes`` gathers in
    row-major mesh order — the JAX mesh's device order."""
    coords, gathered, flat = worlds.get(f"layout_{tag}")
    assert coords == (0, 0, 0) and flat == 0
    assert list(gathered) == order


@functools.lru_cache(maxsize=None)
def _jax_collectives(a):
    """JAX's four reductions over ``TIE_AXES[a]`` of per-device rows,
    each device's answer on a leading axis (one compile per ``a``)."""
    axes = TIE_AXES[a]
    spec = P(("pair", "doppler", "time"))

    def body(v, f, lg):
        loc = JPeak(v[0], f[0], lg[0])
        out = (tuple(jcol.global_peak(loc, axes)),
               tuple(jcol.global_rate_peak(v[0], f[0] % 3, f[0], lg[0],
                                           axes)),
               tuple(jcol.global_peaks(loc, axes, 4, 1, 5)),
               tuple(jcol.global_peaks_batched(
                   JPeak(*(x.reshape(2, -1) for x in loc)), axes, 4, 1, 5)))
        return jax.tree.map(lambda x: x[None], out)

    return jax.jit(jax.shard_map(body, mesh=jax_mesh(2, 2, 2),
                                 in_specs=(spec, spec, spec),
                                 out_specs=spec, check_vma=False))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("a", range(len(TIE_AXES)))
def test_collectives_tie_fuzz_matches_jax(worlds, seed, a):
    """Equal values planted on several ranks: the lowest freq, then the
    lowest lag, wins on every rank — JAX's pmax/pmin lattice — and the
    lattice gathers merge to JAX's rows, rank by rank (over an axis
    subset the fibres differ)."""
    out = _jax_collectives(a)(*_tie_inputs(seed))
    for rank, got in enumerate(worlds.per_rank(f"tie_{seed}_{a}")):
        for g_red, w_red in zip(got, out):
            for g, w in zip(g_red, w_red):
                np.testing.assert_array_equal(np.asarray(g),
                                              np.asarray(w)[rank])


# ---------------------------------------------------------------------------
# The engines, case by case (tests/test_parallel.py's sizes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("doppler", [2, 8])
def test_doppler_sharded_surface_matches_jax(worlds, doppler):
    name = f"surface_d{doppler}"
    got = worlds.get(name)
    want = np.asarray(run_jax(worlds.cases[name]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


PALLAS = ("pallas", "pallas-refine", "pallas-bf16")


@pytest.mark.parametrize("backend", PALLAS)
def test_doppler_sharded_pallas_backends(worlds, backend):
    """The ``pallas*`` backends in each doppler shard (K2 on the card,
    its plain version here) give the single-device ``caf_peak``'s answer
    on the same backend; the K3 surface gathers to ``caf_surface``'s."""
    from caf_cookoff_tpu_torch.models import filterbank as tfb

    c = worlds.cases[f"peak_{backend}"]
    got = worlds.get(f"peak_{backend}")
    want = tfb.caf_peak(*c["args"], backend=backend, device="cpu")
    assert got[:2] == want[:2] == (69.25, 202)
    assert got[2] == pytest.approx(want[2], rel=RTOL)
    surf = worlds.get("surface_pallas")
    want = tfb.caf_surface(*worlds.cases["surface_pallas"]["args"],
                           backend="pallas", device="cpu").numpy()
    np.testing.assert_allclose(surf, want, rtol=RTOL,
                               atol=1e-5 * want.max())


@pytest.mark.parametrize("doppler", [2, 5, 8])
def test_doppler_sharded_peak_golden(worlds, doppler):
    name = f"peak_d{doppler}"
    got = worlds.get(name)
    same_peak(got, run_jax(worlds.cases[name]))
    assert got[:2] == (69.25, 202)


def test_batched_pair_doppler_sharded(worlds):
    got = worlds.get("batched_pd")
    same_rows(got, run_jax(worlds.cases["batched_pd"]))


@pytest.mark.parametrize("doppler,time", [(1, 8), (4, 2), (2, 2)])
def test_time_sharded_overlap_save(worlds, doppler, time):
    name = f"os_d{doppler}_t{time}"
    got = worlds.get(name)
    same_peak(got, run_jax(worlds.cases[name]))
    assert got[:2] == (69.25, 202)


def test_time_sharded_synthetic_long(worlds):
    got = worlds.get("os_synthetic_long")
    same_peak(got, run_jax(worlds.cases["os_synthetic_long"]))
    assert got[:2] == (-1500.0, 51_200)


def test_batched_overlap_save_three_axes(worlds):
    got = worlds.get("os_three_axes")
    same_rows(got, run_jax(worlds.cases["os_three_axes"]))
    _, _, _, f_true, lags = _three_axes()
    assert list(got[0]) == f_true and list(got[1]) == lags


def test_time_sharded_tail_lag(worlds):
    got = worlds.get("os_tail_lag")
    same_peak(got, run_jax(worlds.cases["os_tail_lag"]))
    assert got[:2] == (0.0, _tail_lag()[3])


def test_sharded_determinism(worlds):
    a, b, c = (worlds.get(f"determinism_{x}") for x in "abc")
    assert a == b
    assert a[:2] == c[:2]
    same_peak(a, run_jax(worlds.cases["determinism_a"]))


@pytest.mark.parametrize("doppler", [4, 8])
def test_stein_sharded_peak_golden(worlds, doppler):
    name = f"stein_d{doppler}"
    got = worlds.get(name)
    same_peak(got, run_jax(worlds.cases[name]))
    assert got[:2] == (69.25, 202)


def test_stein_sharded_distant_near_tie(worlds):
    coarse = worlds.get("stein_near_tie_False")
    refined = worlds.get("stein_near_tie_True")
    assert coarse[0] == 0.0
    assert refined[:2] == (168.0, 64)
    same_peak(refined, run_jax(worlds.cases["stein_near_tie_True"]))
    assert coarse[:2] == run_jax(worlds.cases["stein_near_tie_False"])[:2]


def test_stein_sharded_matches_single(worlds):
    from caf_cookoff_tpu_torch.models.stein import stein_caf_peak

    got = worlds.get("stein_chirp3")
    c = worlds.cases["stein_chirp3"]
    same_peak(got, run_jax(c))
    assert got[:2] == stein_caf_peak(*c["args"], device="cpu")[:2] == \
        (-76.25, 151)


def test_sharded_batched_stein_pairs(worlds):
    """K1 (plain version here) in each pair shard: JAX's sharded answers,
    and the port's single-device batched engine bit for bit."""
    got = worlds.get("batched_stein_pairs")
    c = worlds.cases["batched_stein_pairs"]
    same_rows(got, run_jax(c))
    bitwise(got, tbs.batched_stein_peak(*c["args"], device="cpu"))
    # Every sharded array engine reads its answer back as the
    # single-device engines do: the grid's dtype, int32 lags, the values'
    # dtype.
    for name in ("batched_pd", "os_three_axes", "batched_stein_pairs",
                 "p1_os_peaks", "p1_batched", "p1_batched_peaks",
                 "fused_pairs_0", "fused_time_0_t2"):
        fr, lg, vv = worlds.get(name)[:3]
        assert (fr.dtype, lg.dtype, vv.dtype) == (
            np.float32, np.int32, np.float32), name


@pytest.mark.parametrize("seed,n,total,lag,f_idx,g0,gs,gk,doppler,time",
                         FUZZ_CASES)
def test_sharded_fuzz_matches_jax(worlds, seed, n, total, lag, f_idx, g0,
                                  gs, gk, doppler, time):
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    want = (float(freqs[f_idx]), lag)
    kinds = ("fb", "stein") if total == n else ("os",)
    for kind in kinds:
        name = f"fuzz{seed}_{kind}"
        got = worlds.get(name)
        same_peak(got, run_jax(worlds.cases[name]))
        assert got[:2] == want, (kind, got)


@pytest.mark.parametrize("doppler,time", RATE_SHAPES)
def test_sharded_rate_peak_matches_jax(worlds, doppler, time):
    name = f"rate_peak_{doppler}_{time}"
    same_peak(worlds.get(name), run_jax(worlds.cases[name]))


@pytest.mark.parametrize("doppler,time", RATE_SHAPES)
def test_sharded_rate_lattice_emitters_exact(worlds, doppler, time):
    """Both emitters occupy the same slots with the same (rate, freq,
    lag) as JAX's sharded engine, values and SNRs close."""
    name = f"rate_lattice_{doppler}_{time}"
    got = worlds.get(name)
    want = run_jax(worlds.cases[name])
    k = len(RATE_EMITTERS)
    same_rows([np.asarray(g)[:k] for g in got],
              [np.asarray(w)[:k] for w in want], n_int=3)
    got_rows = sorted(zip(np.asarray(got[2])[:k].tolist(),
                          np.asarray(got[0])[:k].tolist()))
    assert got_rows == sorted((lag, r) for _, r, lag, _ in RATE_EMITTERS)


def test_sharded_rate_lattice_noise_only_zero_detections(worlds):
    got = worlds.get("rate_noise")
    assert np.all(np.isneginf(got[3]))
    assert np.all(np.isneginf(run_jax(worlds.cases["rate_noise"])[3]))


def test_sharded_lattices_num_peaks_one(worlds):
    f1, l1, v1 = worlds.get("p1_os")
    fr, lg, vv = worlds.get("p1_os_peaks")
    assert fr.shape == (1,)
    assert (float(fr[0]), int(lg[0]), float(vv[0])) == (f1, l1, v1)
    want = worlds.get("p1_rate")
    same_peak(want, run_jax(worlds.cases["p1_rate"]))
    rr, ff, ll, _ = worlds.get("p1_rate_peaks")
    assert (float(rr[0]), float(ff[0]), int(ll[0])) == want[:3]
    fb, lb, _ = worlds.get("p1_batched")
    frb, lgb, _ = worlds.get("p1_batched_peaks")
    assert frb.shape == (2, 1)
    np.testing.assert_array_equal(frb[:, 0], fb)
    np.testing.assert_array_equal(lgb[:, 0], lb)
    same_rows(worlds.get("p1_batched"), run_jax(worlds.cases["p1_batched"]))
    same_rows(worlds.get("p1_batched_peaks"),
              run_jax(worlds.cases["p1_batched_peaks"]))
    same_peak((f1, l1, v1), run_jax(worlds.cases["p1_os"]))


@pytest.mark.parametrize("i", range(3))
def test_sharded_stein_os_matches_single_device_bitwise(worlds, i):
    """K1 in each time shard: plain and banded grids and the final
    full-overlap lag, bit for bit the port's single-device windowed
    engine at 2 and 4 shards, and (freq, lag) JAX's sharded engine's."""
    nd, hay, freqs, f_inj, lag = _stein_os_cases()[i]
    s = tbs.batched_stein_os_peak(nd[None], hay[None], freqs, FS,
                                  device="cpu")
    single = (float(s[0][0]), int(s[1][0]), float(s[2][0]))
    assert single[:2] == (f_inj, lag)
    for t in (2, 4):
        name = f"stein_os_{i}_t{t}"
        got = worlds.get(name)
        assert got == single, (t, got, single)
        same_peak(got, run_jax(worlds.cases[name]))


def test_sharded_rate_pair_axis_shards_rates(worlds):
    for tag in ("pair2_time2", "pair2_doppler2", "pair4"):
        name = f"rate_pair_{tag}"
        same_peak(worlds.get(name), run_jax(worlds.cases[name]))
    got = worlds.get("rate_pair_lattice")
    want = run_jax(worlds.cases["rate_pair_lattice"])
    same_rows(got, want, n_int=3)
    c = worlds.cases["rate_pair_lattice"]
    single = trate.rate_overlap_save_peaks(*c["args"], **c["kwargs"],
                                           device="cpu")
    np.testing.assert_array_equal(got[0], single[0])
    np.testing.assert_array_equal(got[2], single[2])


@pytest.mark.parametrize("g", range(len(FUSED_GRIDS)))
def test_sharded_fused_lattice_engines_match_single_device(worlds, g):
    """Pair-sharded windowed lattices (K1 (d+e) / (c+d+e)) bit for bit
    the port's single-device engine and JAX's (freq, lag) rows; the
    time-sharded single-pair lattice's emitter rows match at 2 and 4
    shards."""
    name = f"fused_pairs_{g}"
    got = worlds.get(name)
    c = worlds.cases[name]
    single = tbs.batched_stein_os_peaks(*c["args"], **c["kwargs"],
                                        device="cpu")
    bitwise(got, single)
    same_rows(got, run_jax(c))
    want = [(float(f), int(lg)) for f, lg, v in zip(
        single[0][0], single[1][0], single[2][0]) if np.isfinite(v)][:2]
    for t in (2, 4):
        name = f"fused_time_{g}_t{t}"
        fr, lg, vv = worlds.get(name)
        rows = [(float(f), int(x)) for f, x, v in zip(fr, lg, vv)
                if np.isfinite(v)][:2]
        assert rows == want, (t, rows, want)
        jf, jl, jv = run_jax(worlds.cases[name])
        assert rows == [(float(f), int(x)) for f, x, v in zip(jf, jl, jv)
                        if np.isfinite(float(v))][:2]


def test_sharded_segmented_rate_matches_single_device(worlds):
    """K1 (f) in each time shard: bit for bit the port's single-device
    segmented engine (incl. a final-window-region emitter and a banded
    grid) and JAX's sharded answers."""
    for name in ("seg_rate_t2", "seg_rate_t4", "seg_rate_banded_t4"):
        c = worlds.cases[name]
        got = worlds.get(name)
        assert got == trate.stein_rate_os_peak(*c["args"], device="cpu"), \
            name
        same_peak(got, run_jax(c))
