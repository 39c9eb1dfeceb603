"""Scaling of ``parallel/``'s sharded engines over N processes, each on
a core of its own.

    python -m caf_cookoff_tpu_torch.utils.bench_scaling --device cpu [--procs 1,2,4,8] [--engines E,...] [--rounds R] [--out F]
    python -m caf_cookoff_tpu_torch.utils.bench_scaling [--engines doppler,time]

The counterpart of the JAX package's ``bench_scaling.py`` and
``bench_multiproc.py``.  A mesh of the port is processes, one a device,
so the two become one harness with ``bench_multiproc.py``'s method: N
processes started by ``parallel.multihost.launch_local``, each pinned
to a disjoint core (``os.sched_setaffinity``; N above the cores this
process may use is refused) with one torch thread and gloo collectives.
On the card it runs N = 1 on NCCL: ranks that share one card are no
scaling number, and none is printed as one.

Engines, at ``bench_multiproc.py``'s shapes and seeds:

* ``doppler`` (strong): chirp_0 on the 400-bin bench grid,
  ``sharded_caf_peak`` with the bins over N ranks;
* ``pair`` (weak): 2 pairs a rank, ``batched_caf_peak`` over ``pair``;
* ``time`` (strong): one capture of 65536 lags, ``sharded_overlap_save_
  peak`` with the lags over ``time``;
* ``rate`` (strong): 5 trial rates over 131072 lags,
  ``sharded_rate_overlap_save_peak`` over ``time``;
* ``config5_dt`` / ``config5_pt`` (strong): 4 pairs x 64 bins x 32768
  lags, two emitters a pair, ``batched_overlap_save_peaks`` on a doppler
  x time or pair x time mesh (2 x 2 at N = 4).

Each point is gated on the golden answer or the injected truths before
it is timed (:class:`GateError`).  Then rounds of two calls, in turns
(which one goes first alternates), each after a barrier and timed on
rank 0's clock, whole (host answers): ``full_ms``, the sharded engine,
and ``compute_ms``, the same shard's work through the engine's own
shard helper (``parallel/sharded.py``) with no collective.
``collective_ms`` = full - compute, as measured, even when negative;
``efficiency`` and ``compute_efficiency`` as ``bench_multiproc.py``
forms them (strong: T1 / (N T_N), weak: T1 / T_N, from the medians).
One JSON line per (engine, N); ``--out F`` writes them as one document.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

FS = 48_000.0
ROUNDS = 5
WARMUP = 2
ENGINES = ("doppler", "pair", "time", "rate", "config5_dt", "config5_pt")
ROOT = pathlib.Path(__file__).resolve().parents[2]
# bench_multiproc.py:44-69's shapes and gate seeds.
DOPPLER_GATE = (69.25, 202)
SHAPES = {
    "doppler": dict(grid=[-100.0, 100.0, 0.5]),
    "pair": dict(per_proc=2, n=4096, num_bins=64, seed=9),
    "time": dict(n=1024, total_lags=65_536, num_bins=64, seed=3),
    "rate": dict(n=1024, total_lags=131_072, num_bins=64, seed=17),
    "config5_dt": dict(n=1024, total_lags=32_768, num_bins=64, pairs=4,
                       num_peaks=2, seed=11),
    "config5_pt": dict(n=1024, total_lags=32_768, num_bins=64, pairs=4,
                       num_peaks=2, seed=11),
}


class GateError(AssertionError):
    """A mesh point's answer is not its truth: it is not timed."""


def _gate(cond: bool, what: str) -> None:
    if not cond:
        raise GateError(what)


@dataclass
class Point:
    """One engine at one mesh: ``full()`` the sharded engine's host
    answer, ``compute()`` its shard's work alone (host values),
    ``check(answer)`` the gate."""
    label: str
    mode: str
    full: Callable[[], object]
    compute: Callable[[], object]
    check: Callable[[object], None]
    mesh: Dict[str, int] = field(default_factory=dict)


def _noise(rng, *shape, scale: float = 1.0):
    """``(scale * (re + 1j im)).astype(complex64)`` of two normal draws,
    as the JAX harness writes its needles and noise."""
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _grid(k: int) -> np.ndarray:
    return np.linspace(-100, 100, k, endpoint=False).astype(np.float32)


def _on(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _doppler(world, dev, shape, data_dir):
    from caf_cookoff_tpu_torch.config import FreqGrid
    from caf_cookoff_tpu_torch.parallel import make_mesh, sharded_caf_peak
    from caf_cookoff_tpu_torch.parallel.sharded import _caf_peak_shard
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle_path, hay_path = ensure_fixtures(pathlib.Path(data_dir))[0]
    needle = load_c64(needle_path)
    hay = load_c64(hay_path, count=len(needle))
    freqs = FreqGrid(*shape["grid"]).frequencies(np.float32)
    mesh = make_mesh(doppler=world, device=dev)
    n, h = _on(needle, mesh.device), _on(hay, mesh.device)

    def check(got):
        _gate(abs(got[0] - DOPPLER_GATE[0]) <= 0.5
              and got[1] == DOPPLER_GATE[1],
              f"doppler N={world}: {got[:2]}, want {DOPPLER_GATE}")

    return Point(
        f"doppler_strong_{len(freqs)}x{2 * len(needle)}", "strong",
        lambda: sharded_caf_peak(n, h, freqs, FS, mesh, backend="xla"),
        lambda: _caf_peak_shard(n, h, freqs, FS, mesh, "xla")[0].value.item(),
        check, dict(mesh.shape))


def _pair(world, dev, shape, data_dir):
    from caf_cookoff_tpu_torch.parallel import batched_caf_peak, make_mesh
    from caf_cookoff_tpu_torch.parallel.sharded import _batched_caf_peak_shard

    n, k = shape["n"], shape["num_bins"]
    batch = shape["per_proc"] * world
    freqs = _grid(k)
    rng = np.random.default_rng(shape["seed"])
    truths = [(float(freqs[5 + 2 * b]), 50 + 3 * b) for b in range(batch)]
    needles = _noise(rng, batch, n)
    hays = np.zeros((batch, n), np.complex64)
    t = np.arange(n)
    for b, (f, lag) in enumerate(truths):
        hays[b, lag:] = (needles[b] * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)[: n - lag]
    mesh = make_mesh(pair=world, device=dev)
    ns, hs = _on(needles, mesh.device), _on(hays, mesh.device)

    def check(got):
        rows = [(float(f), int(x)) for f, x in zip(got[0], got[1])]
        _gate(rows == truths, f"pair N={world}: {rows}, want {truths}")

    return Point(
        f"pair_weak_{shape['per_proc']}perproc_{k}x{2 * n}", "weak",
        lambda: batched_caf_peak(ns, hs, freqs, FS, mesh, backend="xla"),
        lambda: _batched_caf_peak_shard(ns, hs, freqs, FS, mesh,
                                        "xla")[0].value.cpu(),
        check, dict(mesh.shape))


def _time_inputs(shape):
    """bench_multiproc.py's ``_worker_time`` capture: (needle, capture,
    grid, truth (freq, lag) at the last lag)."""
    n, total_lags, k = shape["n"], shape["total_lags"], shape["num_bins"]
    rng = np.random.default_rng(shape["seed"])
    needle = _noise(rng, n)
    hay = _noise(rng, total_lags + n - 1, scale=1e-4)
    freqs = _grid(k)
    truth = (float(freqs[k // 3]), total_lags - 1)
    t = np.arange(n)
    hay[truth[1]:truth[1] + n] += (needle * np.exp(
        2j * np.pi * truth[0] * t / FS)).astype(np.complex64)[
            : len(hay) - truth[1]]
    return needle, hay, freqs, truth


def _time(world, dev, shape, data_dir):
    from caf_cookoff_tpu_torch.parallel import (make_mesh,
                                                sharded_overlap_save_peak)
    from caf_cookoff_tpu_torch.parallel.sharded import _os_peak_shard

    needle, hay, freqs, truth = _time_inputs(shape)
    lags = shape["total_lags"]
    mesh = make_mesh(time=world, device=dev)
    n, h = _on(needle, mesh.device), _on(hay, mesh.device)

    def check(got):
        _gate(tuple(got[:2]) == truth,
              f"time N={world}: {got[:2]}, want {truth}")

    return Point(
        f"time_strong_{len(freqs)}x{lags}", "strong",
        lambda: sharded_overlap_save_peak(n, h, freqs, FS, mesh,
                                          num_lags=lags, backend="xla"),
        lambda: _os_peak_shard(n, h, freqs, FS, mesh, lags,
                               "xla")[0].value.item(),
        check, dict(mesh.shape))


def _rate(world, dev, shape, data_dir):
    from caf_cookoff_tpu_torch.parallel import (
        make_mesh, sharded_rate_overlap_save_peak)
    from caf_cookoff_tpu_torch.parallel.sharded import _rate_os_peak_shard

    n, total_lags, k = shape["n"], shape["total_lags"], shape["num_bins"]
    rng = np.random.default_rng(shape["seed"])
    needle = _noise(rng, n)
    hay = _noise(rng, total_lags + n - 1, scale=1e-4)
    freqs = _grid(k)
    # A rate grid at the window's resolution cell 1/T^2 (~2.2 kHz/s).
    rates = np.arange(-4000.0, 4001.0, 2000.0).astype(np.float32)
    truth = (float(rates[3]), float(freqs[k // 3]), total_lags - 1)
    t_sec = np.arange(n) / FS
    sw = (needle * np.exp(2j * np.pi * truth[1] * t_sec
                          + 1j * np.pi * truth[0] * t_sec ** 2)
          ).astype(np.complex64)
    hay[truth[2]:truth[2] + n] += sw[: len(hay) - truth[2]]
    mesh = make_mesh(time=world, device=dev)
    nt, h = _on(needle, mesh.device), _on(hay, mesh.device)

    def check(got):
        _gate(tuple(got[:3]) == truth,
              f"rate N={world}: {got[:3]}, want {truth}")

    return Point(
        f"rate_strong_{len(rates)}x{k}x{total_lags}", "strong",
        lambda: sharded_rate_overlap_save_peak(
            nt, h, freqs, rates, FS, mesh, num_lags=total_lags,
            backend="xla"),
        lambda: _rate_os_peak_shard(nt, h, freqs, rates, FS, mesh,
                                    total_lags, "xla")[0][0].item(),
        check, dict(mesh.shape))


def _config5(axes):
    def build(world, dev, shape, data_dir):
        from caf_cookoff_tpu_torch.parallel import (batched_overlap_save_peaks,
                                                    make_mesh)
        from caf_cookoff_tpu_torch.parallel.sharded import (
            _batched_os_peaks_shard)

        n, total_lags, k = shape["n"], shape["total_lags"], shape["num_bins"]
        batch, num_peaks = shape["pairs"], shape["num_peaks"]
        tm = min(world, 2)          # time axis: 1, 2, 2, 2 at N = 1, 2, 4, 8
        om = world // tm            # the other axis (doppler or pair)
        rng = np.random.default_rng(shape["seed"])
        freqs = _grid(k)
        needles = _noise(rng, batch, n)
        hays = _noise(rng, batch, total_lags + n - 1, scale=1e-4)
        t = np.arange(n)
        truths = []          # per pair: [(freq, lag)], strongest first
        for b in range(batch):
            pair_truths = [(float(freqs[7 + 5 * b]), 900 + 1000 * b),
                           (float(freqs[40 - 4 * b]),
                            total_lags - 1 - 700 * b)]
            for amp, (f, lag) in zip((1.0, 0.7), pair_truths):
                end = min(lag + n, hays.shape[1])
                hays[b, lag:end] += (amp * needles[b] * np.exp(
                    2j * np.pi * f * t / FS)).astype(np.complex64)[
                        : end - lag]
            truths.append(pair_truths)
        other = "doppler" if axes == "dt" else "pair"
        mesh = make_mesh(time=tm, device=dev, **{other: om})
        ns, hs = _on(needles, mesh.device), _on(hays, mesh.device)

        def check(got):
            rows = [[(float(f), int(x)) for f, x in zip(fr, lg)]
                    for fr, lg in zip(got[0], got[1])]
            _gate(rows == truths,
                  f"config5_{axes} N={world}: {rows}, want {truths}")

        return Point(
            f"config5_{axes}_{batch}pair_{k}x{total_lags}_mesh{om}x{tm}",
            "strong",
            lambda: batched_overlap_save_peaks(
                ns, hs, freqs, FS, mesh, num_peaks, num_lags=total_lags,
                backend="xla"),
            lambda: _batched_os_peaks_shard(
                ns, hs, freqs, FS, mesh, num_peaks, total_lags, None, None,
                "xla")[0].value.cpu(),
            check, dict(mesh.shape))
    return build


POINTS = {"doppler": _doppler, "pair": _pair, "time": _time, "rate": _rate,
          "config5_dt": _config5("dt"), "config5_pt": _config5("pt")}


def _reduced(engine: str, shape: Dict) -> List[str]:
    return [f"{k}={v} (full {SHAPES[engine][k]})"
            for k, v in sorted(shape.items()) if v != SHAPES[engine][k]]


def _timed(fn) -> float:
    """One whole call after a barrier, on this rank's clock (ms)."""
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _stats(ms: List[float]) -> Dict:
    return {"best_ms": min(ms), "median_ms": statistics.median(ms),
            "spread_ms": max(ms) - min(ms), "rounds": len(ms)}


def measure_point(engine: str, world: int, device, *, rounds: int = ROUNDS,
                  shape: Optional[Dict] = None,
                  data_dir=ROOT / "data") -> Dict:
    """Inside a rank of a formed world: ``engine`` at a mesh of ``world``
    ranks, gated, warmed up, then ``rounds`` rounds of its full and
    compute calls in turns."""
    shape = {**SHAPES[engine], **(shape or {})}
    dev = "cpu" if torch.device(device).type == "cpu" else None
    point = POINTS[engine](world, dev, shape, data_dir)
    point.check(point.full())
    for _ in range(WARMUP):
        point.full()
        point.compute()
    full, comp = [], []
    for r in range(rounds):
        turns = ((point.full, full), (point.compute, comp))
        for fn, acc in (turns if r % 2 == 0 else turns[::-1]):
            acc.append(_timed(fn))
    f, c = _stats(full), _stats(comp)
    return {"metric": f"scaling_{point.label}", "engine": engine,
            "label": point.label, "n": world, "mode": point.mode,
            "mesh": point.mesh, "full_ms": f["median_ms"],
            "compute_ms": c["median_ms"],
            "collective_ms": f["median_ms"] - c["median_ms"],
            "full": f, "compute": c, "gate": "passed",
            "reduced": _reduced(engine, {k: v for k, v in shape.items()
                                         if k in SHAPES[engine]})}


def _rank(args) -> int:
    """One rank of a world (``--worker``): pin, form the world, measure
    each engine; rank 0 prints one ``POINT`` line an engine."""
    import torch.distributed as dist

    from caf_cookoff_tpu_torch.parallel import multihost

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cpu = args.device == "cpu"
    cores = [int(c) for c in args.cores.split(",") if c]
    if cpu:
        os.sched_setaffinity(0, {cores[rank]})
        torch.set_num_threads(1)
    multihost.initialize_cluster(backend="gloo" if cpu else "nccl",
                                 timeout=datetime.timedelta(seconds=600))
    shapes = json.loads(args.shapes)
    for engine in args.engines.split(","):
        out = measure_point(engine, world, args.device, rounds=args.rounds,
                            shape=shapes.get(engine), data_dir=args.data_dir)
        if rank == 0:
            out.update(device=args.device, collectives=dist.get_backend(),
                       pinned_cores=cores[:world] if cpu else None)
            print("POINT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def usable_cores() -> List[int]:
    return sorted(os.sched_getaffinity(0))


def check_procs(procs: List[int], device) -> None:
    """Refuse what gives no scaling number: more processes than usable
    cores (pins must be disjoint), or more than one rank on the card."""
    if torch.device(device).type == "cuda":
        if procs != [1]:
            raise ValueError("on the card the harness runs N = 1 only: "
                             "ranks sharing one card are no scaling number")
        return
    cores = usable_cores()
    if max(procs) > len(cores):
        raise ValueError(f"--procs max {max(procs)} exceeds the "
                         f"{len(cores)} usable cores (pins must be "
                         "disjoint)")


def efficiencies(rows: List[Dict]) -> None:
    """Add ``efficiency`` and ``compute_efficiency`` to one engine's rows
    (strong: T1 / (N T_N); weak: T1 / T_N), from the N = 1 row."""
    one = [r for r in rows if r["n"] == 1]
    if not one:
        return
    t1, c1 = one[0]["full_ms"], one[0]["compute_ms"]
    for r in rows:
        nd = r["n"] if r["mode"] == "strong" else 1
        r["efficiency"] = t1 / (nd * r["full_ms"])
        r["compute_efficiency"] = c1 / (nd * r["compute_ms"])


def run(engines, procs, device="cuda", *, rounds: int = ROUNDS,
        shapes: Optional[Dict] = None, data_dir=ROOT / "data",
        timeout: float = 3600.0) -> List[Dict]:
    """One world a process count, each rank on a core of its own (or the
    card at N = 1): the points' lines, with efficiencies off the card."""
    from caf_cookoff_tpu_torch.parallel import multihost

    procs = [int(p) for p in procs]
    check_procs(procs, device)
    cpu = torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA card; pass device='cpu'")
    argv = [sys.executable, "-m", "caf_cookoff_tpu_torch.utils.bench_scaling",
            "--worker", "--device", "cpu" if cpu else "cuda",
            "--engines", ",".join(engines), "--rounds", str(rounds),
            "--shapes", json.dumps(shapes or {}), "--data-dir",
            str(data_dir), "--cores", ",".join(map(str, usable_cores()))]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    by_engine: Dict[str, List[Dict]] = {e: [] for e in engines}
    for n in procs:
        outs = multihost.wait_local(multihost.launch_local(argv, n, env=env),
                                    timeout)
        for rank, (rc, text) in enumerate(outs):
            if rc:
                cls = GateError if "GateError" in text else RuntimeError
                raise cls(f"N={n} rank {rank} exited {rc}:\n{text[-3000:]}")
        for line in outs[0][1].splitlines():
            if line.startswith("POINT "):
                point = json.loads(line[len("POINT "):])
                by_engine[point["engine"]].append(point)
    lines = []
    for engine in engines:
        if cpu:
            efficiencies(by_engine[engine])
        lines += by_engine[engine]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", default=None,
                    help="process counts, e.g. 1,2,4,8 (default: 1,2,4,8 "
                         "capped at the usable cores on the CPU; 1 on the "
                         "card)")
    ap.add_argument("--engines", default=",".join(ENGINES))
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--data-dir", default=str(ROOT / "data"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cores", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _rank(args)
    engines = [e.strip() for e in args.engines.split(",")]
    for e in engines:
        if e not in POINTS:
            ap.error(f"unknown engine {e!r}; engines are {ENGINES}")
    cpu = torch.device(args.device).type == "cpu"
    if args.procs:
        procs = [int(p) for p in args.procs.split(",")]
    else:
        procs = ([p for p in (1, 2, 4, 8) if p <= len(usable_cores())]
                 if cpu else [1])
    try:
        lines = run(engines, procs, args.device, rounds=args.rounds)
    except ValueError as exc:
        ap.error(str(exc))
    except GateError as exc:
        print(f"bench_scaling: gate failed: {exc}", file=sys.stderr)
        return 1
    for line in lines:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"method": "one process a mesh position, each pinned "
                                 "to its own core (CPU, gloo) or the card "
                                 "at N = 1 (NCCL)",
                       "cores": len(usable_cores()), "lines": lines}, f,
                      indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
