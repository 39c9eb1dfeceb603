"""The port's benchmark: every cell gated, then timed in interleaved
rounds on one CUDA card.

    python -m caf_cookoff_tpu_torch.utils.bench_configs [CELL ...] [--rounds R] [--out F]
    python -m caf_cookoff_tpu_torch.utils.bench_configs headline
    python -m caf_cookoff_tpu_torch.utils.bench_configs CELL ... --device cpu

The counterpart of the JAX package's root harnesses ``bench.py``,
``bench_configs.py``, ``docs/bench_multi_emitter.py`` and
``docs/bench_rate.py``: their workloads (the numpy recipes copied, byte
for byte) and their correctness gates, with the timing a user of the
port sees.  A timed call is the whole public call, from inputs already
on the card to the host answer (Python floats or numpy arrays), host
work included.

Method, per selected cell: build its inputs and put them on the card
once; run its gate, which raises :class:`GateError` naming the cell
before anything is timed; warm each engine up with ``WARMUP`` calls.
Then ``--rounds`` rounds: each round calls every selected (cell,
engine) once, timed with CUDA events, in an order rotated from round to
round, so slow drift of the host lands on every cell alike.  Last, a
``torch.profiler`` pass (apart from the timed rounds) counts the device
operations of one call and sums their device time (kernels replayed
from a CUDA graph included), and counts the call's host waits on the
card and its copies between host and card.

One JSON line per (cell, engine): ``metric`` (the port's own names),
``value`` (the median ms), ``best_ms``, ``median_ms``, ``spread_ms``
(max - min), ``rounds``, ``device_ms``, ``device_ops``, ``host_share``
(1 - device_ms / median_ms: the device's idle share during a call),
``syncs`` (``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` /
``cudaEventSynchronize`` calls a call), ``copies`` (host-to-card and
card-to-host copies a call), ``captures`` (CUDA graphs the compiled
calls captured during the engine's timed rounds: 0 unless a key was
evicted from ``ops/_graph``'s cache and captured again), the
cell's units (ms a surface or a pair, samples a second), the card's
name and ``nvidia-smi`` power limit, the git commit, and ``reduced``
where the cell was not run at its full width.  ``headline`` prints one
line for config 1 with ``vs_baseline``, the reference's published CPU
number (28 ms a surface, RustFFT and a thread pool) over the median.
``--out F`` writes every line into one JSON document.  Timing needs a
CUDA card; ``--device cpu`` runs the gates alone and prints untimed
lines.  A failed gate exits non-zero with the cell's name.

config5 is a gate only: its 8 ranks (a pair=2 x doppler=2 x time=2 mesh)
run as child processes with gloo collectives, all on the one card (or
the CPU): ranks that share a card time no scaling.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from caf_cookoff_tpu_torch.ops import _graph

FS = 48_000.0
BASELINE_MS = 28.0     # the reference's CPU ms a surface (RustFFT + pool)
ROUNDS = 7
WARMUP = 3
STREAM_CHUNK = 8192    # stream3 / stream1000: 8 full chunks, one of 4096
RATES = np.arange(-200.0, 201.0, 50.0, dtype=np.float32)   # R = 9
LATTICE_SLOTS = {"lattice2": 2, "lattice4": 3, "ratelat3": 3,
                 "stream3": 3}
ROOT = pathlib.Path(__file__).resolve().parents[2]


class GateError(AssertionError):
    """A cell's answer is not its truth: nothing of it is timed."""


def _gate(cond: bool, cell: str, what: str) -> None:
    if not cond:
        raise GateError(f"{cell}: {what}")


# ---------------------------------------------------------------------------
# Inputs: the JAX harnesses' numpy recipes.  Each builder takes the shape
# arguments the CPU tests shrink; at the defaults it is the recipe, and
# positions of emitters scale with the shape so that they stay inside it.
# ---------------------------------------------------------------------------


def _at(full_index: int, size: int, full_size: int) -> int:
    """A recipe's index into an axis of ``full_size``, moved to an axis of
    ``size`` (the index itself at the full size)."""
    return full_index * size // full_size


def _rand_pair(n, lag, f_hz, seed):
    """``bench_configs.py``'s pair: a noise needle, and as haystack its
    copy delayed by ``lag`` and shifted by ``f_hz``."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    hay = np.zeros(n, dtype=np.complex64)
    hay[lag:] = needle[: n - lag]
    hay *= np.exp(2j * np.pi * f_hz * np.arange(n) / FS).astype(np.complex64)
    return needle, hay


def _chirp0(data_dir):
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle_path, haystack_path = ensure_fixtures(pathlib.Path(data_dir))[0]
    needle = load_c64(needle_path)
    return needle, load_c64(haystack_path, count=len(needle))


def build_config1(data_dir=ROOT / "data", step_hz: float = 0.5):
    """``bench.py``'s workload: chirp_0 on the 400-bin bench grid (or the
    same span at ``step_hz``) -> (needle, haystack, freqs)."""
    from caf_cookoff_tpu_torch.config import BENCH_GRID, FreqGrid

    needle, hay = _chirp0(data_dir)
    grid = FreqGrid(BENCH_GRID.start_hz, BENCH_GRID.stop_hz, step_hz)
    return needle, hay, grid.frequencies(np.float32)


def build_config2(pairs: int = 64, n: int = 4096):
    """``bench_configs.py:164-181``: -> (needles, haystacks, freqs, None,
    None)."""
    from caf_cookoff_tpu_torch.config import BENCH_GRID

    built = [_rand_pair(n, 50 + i, 10.0 * i - 300, i) for i in range(pairs)]
    return (np.stack([p[0] for p in built]), np.stack([p[1] for p in built]),
            BENCH_GRID.frequencies(np.float32), None, None)


def build_config3(n: int = 4096, lags: int = 65536, k: int = 2000):
    """``bench_configs.py:211-223``: one needle against ``lags + n``
    samples of noise with an emitter at (freqs[1234], 30000) ->
    (needles (1, n), haystacks (1, lags + n), freqs, lags, [truth])."""
    needle, _ = _rand_pair(n, 7, 0.0, 0)
    rng = np.random.default_rng(1)
    hay = (rng.standard_normal(lags + n)
           + 1j * rng.standard_normal(lags + n)).astype(np.complex64)
    freqs = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    true_f = float(freqs[_at(1234, k, 2000)])
    true_lag = _at(30_000, lags, 65536)
    t = np.arange(n)
    hay[true_lag:true_lag + n] += 3 * (needle * np.exp(
        2j * np.pi * true_f * t / FS)).astype(np.complex64)
    return needle[None], hay[None], freqs, lags, [(true_f, true_lag)]


def build_config4(pairs: int = 16, n: int = 4096, lags: int = 32768,
                  k: int = 1024):
    """``bench_configs.py:270-290``: one emitter a pair -> (needles,
    haystacks, freqs, lags, truths)."""
    rng = np.random.default_rng(2)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n)))
            ).astype(np.complex64)
    freqs = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    truths = []
    for b in range(pairs):
        lag = _at(777 + b * 2011, lags, 32768)
        f_hz = float(freqs[_at(61 * (b + 1), k, 1024)])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)[: lags + n - lag]
        truths.append((f_hz, lag))
    return needles, hays, freqs, lags, truths


def build_config5(pairs: int = 8, n: int = 1024, lags: int = 16_384,
                  k: int = 64):
    """``bench_configs.py:359-375`` (``config5_virtual``) -> (needles,
    haystacks, freqs, lags, truths)."""
    rng = np.random.default_rng(4)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n)))
            ).astype(np.complex64)
    freqs = np.linspace(-100, 100, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    truths = []
    for b in range(pairs):
        lag = _at(500 + b * 1777, lags, 16_384)
        f_hz = float(freqs[_at(5 + 7 * b, k, 64)])
        hays[b, lag:lag + n] += (needles[b] * np.exp(
            2j * np.pi * f_hz * t / FS)).astype(np.complex64)
        truths.append((f_hz, lag))
    return needles, hays, freqs, lags, truths


def build_lattice2(pairs: int = 64, n: int = 4096):
    """Config 2's shape with two emitters a pair, in bins 200 apart, each
    the needle delayed and shifted -> (needles, haystacks, freqs, None,
    per-pair [(freq, lag)] truths)."""
    from caf_cookoff_tpu_torch.config import BENCH_GRID

    grid = BENCH_GRID.frequencies(np.float32)
    rng = np.random.default_rng(3)
    t = np.arange(n)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, n))
                    + 1j * rng.standard_normal((pairs, n)))
            ).astype(np.complex64)
    truths = []
    for i in range(pairs):
        es = [(50 + i, 20 + 5 * i, 1.0),
              (600 + 7 * i, (220 + 5 * i) % 400, 0.7)]
        for lag, kk, amp in es:
            hays[i, lag:] += (amp * needles[i, :n - lag] * np.exp(
                2j * np.pi * grid[kk] * t[lag:] / FS)).astype(np.complex64)
        truths.append([(float(grid[kk]), lag) for lag, kk, _ in es])
    return needles, hays, grid, None, truths


def build_lattice4(pairs: int = 16, n: int = 4096, lags: int = 32768,
                   k: int = 1024):
    """``docs/bench_multi_emitter.py:65-87``: config 4 with two emitters
    a pair -> (needles, haystacks, freqs, lags, per-pair truths)."""
    rng = np.random.default_rng(2)
    needles = (rng.standard_normal((pairs, n))
               + 1j * rng.standard_normal((pairs, n))).astype(np.complex64)
    hays = (1e-4 * (rng.standard_normal((pairs, lags + n))
                    + 1j * rng.standard_normal((pairs, lags + n)))
            ).astype(np.complex64)
    freqs = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    t = np.arange(n)
    truths = []
    for b in range(pairs):
        rows = []
        for lag, f_idx, amp in (
                (_at(777 + b * 1813, lags, 32768), _at(61 * (b + 1), k, 1024),
                 1.0),
                (_at(17000 + b * 911, lags, 32768), _at(997 - 53 * b, k, 1024),
                 0.7)):
            f_hz = float(freqs[f_idx])
            hays[b, lag:lag + n] += (amp * needles[b] * np.exp(
                2j * np.pi * f_hz * t / FS)).astype(np.complex64)[
                    : lags + n - lag]
            rows.append((f_hz, lag))
        truths.append(rows)
    return needles, hays, freqs, lags, truths


def build_rate3(n: int = 4096, lags: int = 65536, k: int = 2000):
    """``docs/bench_rate.py:61-76`` (rate3) and rate3 with a second,
    weaker emitter (ratelat3) -> {"rate3": ..., "ratelat3": ...}, each
    (needle, haystack (lags + n), freqs, rates, lags, [(rate, freq, lag)]
    truths, strongest first)."""
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(lags + n)
                   + 1j * rng.standard_normal(lags + n))).astype(np.complex64)
    freqs = np.linspace(-500, 500, k, endpoint=False).astype(np.float32)
    t = np.arange(n)

    def add(h, rate, f_hz, lag, amp):
        ph = 2 * np.pi * f_hz * t / FS + np.pi * rate * (t / FS) ** 2
        h[lag:lag + n] += amp * (needle * np.exp(1j * ph)).astype(np.complex64)

    e1 = (150.0, float(freqs[_at(1234, k, 2000)]), _at(30_000, lags, 65536))
    add(hay, *e1, 3.0)
    two = hay.copy()
    e2 = (-100.0, float(freqs[_at(345, k, 2000)]), _at(12_000, lags, 65536))
    add(two, *e2, 1.5)
    return {"rate3": (needle, hay, freqs, RATES, lags, [e1]),
            "ratelat3": (needle, two, freqs, RATES, lags, [e1, e2])}


def build_stream3(n: int = 4096, lags: int = 65536, k: int = 2000):
    """stream3: config 3's capture and its two-emitter version (freqs[345]
    at lag 12000, amplitude 1.5, as ratelat3 adds its second emitter) ->
    (needle, capture, two-emitter capture, freqs, truth, [truth, second])."""
    needles, hays, freqs, _, truths = build_config3(n, lags, k)
    needle, hay = needles[0], hays[0]
    f2, lag2 = float(freqs[_at(345, k, 2000)]), _at(12_000, lags, 65536)
    two = hay.copy()
    two[lag2:lag2 + n] += 1.5 * (needle * np.exp(
        2j * np.pi * f2 * np.arange(n) / FS)).astype(np.complex64)
    return needle, hay, two, freqs, truths[0], [truths[0], (f2, lag2)]


# ---------------------------------------------------------------------------
# Cells: inputs on the device, the gate, the timed engines and units
# ---------------------------------------------------------------------------


@dataclass
class Engine:
    """One timed public call of a cell; ``units(median_ms)`` gives the
    cell's extra unit fields."""
    name: str
    call: Callable[[], object]
    units: Callable[[float], Dict] = lambda ms: {}


@dataclass
class Cell:
    name: str
    shape: str
    device: torch.device
    gate: Callable[[], None]
    engines: List[Engine] = field(default_factory=list)
    reduced: List[str] = field(default_factory=list)
    timed: bool = True


def _reduced(builder, shape: Dict) -> List[str]:
    """``"name=value (full F)"`` for each shape argument off the
    builder's default."""
    import inspect

    params = inspect.signature(builder).parameters
    return [f"{k}={v} (full {params[k].default})" for k, v in
            sorted(shape.items())
            if k != "data_dir" and v != params[k].default]


def _on(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _per(count: int, key: str):
    return lambda ms: {key: ms / count}


def _samples_per_s(samples: int):
    return lambda ms: {"samples_per_s": samples / (ms / 1e3),
                       "real_time_samples_per_s": FS}


def _rows(fr, lg, vv):
    return [(float(f), int(x)) for f, x, v in zip(fr, lg, vv)
            if np.isfinite(v)]


def cell_config1(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import caf_peak

    needle, hay, freqs = build_config1(**shape)
    n, h = _on(needle, dev), _on(hay, dev)

    def call():
        return caf_peak(n, h, freqs, FS, backend="stein", device=dev)

    def gate():
        freq, lag, val = call()
        _gate(abs(freq - 69.25) <= 0.5 and lag == 202 and val > 0,
              "config1", f"stein ({freq}, {lag}), want (69.25 +- 0.5, 202)")

    return Cell("config1", f"{len(freqs)}x{2 * len(needle)}", dev, gate,
                [Engine("stein", call)], _reduced(build_config1, shape))


def cell_config2(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import batched_stein_peak, stein_caf_peak

    needles, hays, freqs, _, _ = build_config2(**shape)
    ns, hs = _on(needles, dev), _on(hays, dev)
    pairs = len(needles)

    def call():
        return batched_stein_peak(ns, hs, freqs, FS, device=dev)

    def gate():
        fr, lg, _ = call()
        for i in range(0, pairs, 13):
            want = stein_caf_peak(ns[i], hs[i], freqs, FS, device=dev)[:2]
            _gate((float(fr[i]), int(lg[i])) == want, "config2",
                  f"pair {i}: batch ({fr[i]}, {lg[i]}), single-pair {want}")

    return Cell("config2", f"{pairs}x{len(freqs)}x{2 * needles.shape[1]}",
                dev, gate, [Engine("stein", call,
                                   _per(pairs, "ms_per_surface"))],
                _reduced(build_config2, shape))


def _os_cell(name, builder, dev, shape, per_pair: bool) -> Cell:
    from caf_cookoff_tpu_torch import batched_stein_os_peak

    needles, hays, freqs, lags, truths = builder(**shape)
    ns, hs = _on(needles, dev), _on(hays, dev)

    def call():
        return batched_stein_os_peak(ns, hs, freqs, FS, num_lags=lags,
                                     device=dev)

    def gate():
        fr, lg, _ = call()
        got = [(float(f), int(x)) for f, x in zip(fr, lg)]
        _gate(got == truths, name, f"got {got}, want {truths}")

    units = _per(len(needles), "ms_per_pair") if per_pair else (
        lambda ms: {})
    return Cell(name, f"{len(needles)}x{len(freqs)}x{lags}", dev, gate,
                [Engine("stein", call, units)], _reduced(builder, shape))


def cell_config3(dev, **shape) -> Cell:
    return _os_cell("config3", build_config3, dev, shape, per_pair=False)


def cell_config4(dev, **shape) -> Cell:
    return _os_cell("config4", build_config4, dev, shape, per_pair=True)


def cell_config5(dev, **shape) -> Cell:
    needles, _, freqs, lags, _ = build_config5(**shape)

    def gate():
        _config5_world(dev, shape)

    return Cell("config5", f"{len(needles)}x{len(freqs)}x{lags}", dev, gate,
                [], _reduced(build_config5, shape), timed=False)


def _config5_world(dev, shape: Dict, timeout: float = 600.0) -> None:
    """config 5's gate: 8 ranks in child processes, a pair=2 x doppler=2
    x time=2 mesh with gloo collectives on ``dev`` (all ranks share one
    card), ``batched_overlap_save_peak`` on every rank equal to the
    truths."""
    from caf_cookoff_tpu_torch.parallel import multihost

    argv = [sys.executable, "-m", "caf_cookoff_tpu_torch.utils.bench_configs",
            "--config5-rank", "--device", "cuda:0" if dev.type == "cuda"
            else "cpu", "--shape", json.dumps(shape)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    outs = multihost.wait_local(multihost.launch_local(argv, 8, env=env),
                                timeout)
    for rank, (rc, text) in enumerate(outs):
        _gate(rc == 0, "config5", f"rank {rank} exited {rc}:\n{text[-2000:]}")


def _config5_rank(device: str, shape: Dict) -> int:
    import datetime

    from caf_cookoff_tpu_torch.parallel import (batched_overlap_save_peak,
                                                make_mesh, multihost)

    if device == "cpu":
        torch.set_num_threads(1)
    multihost.initialize_cluster(backend="gloo",
                                 timeout=datetime.timedelta(seconds=300))
    needles, hays, freqs, lags, truths = build_config5(**shape)
    mesh = make_mesh(pair=2, doppler=2, time=2, device=device,
                     collectives="gloo")
    fr, lg, _ = batched_overlap_save_peak(needles, hays, freqs, FS, mesh,
                                          num_lags=lags, backend="xla")
    got = [(float(f), int(x)) for f, x in zip(fr, lg)]
    torch.distributed.destroy_process_group()
    _gate(got == truths, "config5", f"rank {mesh.rank}: got {got}, want "
                                    f"{truths}")
    return 0


def _lattice_oracle(ns, hs, freqs, num, ef, el, pairs, dev):
    """Pairs ``pairs`` of an equal-length lattice cell through
    ``find_peaks`` on the cuFFT surface: [(rows, values)]."""
    from caf_cookoff_tpu_torch import caf_surface, find_peaks

    out = []
    for i in pairs:
        surf = caf_surface(ns[i], hs[i], freqs, FS, backend="xla",
                           device=dev)
        pk = find_peaks(surf, num, ef, el, lag_period=2 * ns.shape[-1])
        out.append(([(float(freqs[int(f)]), int(x)) for f, x in
                     zip(pk.freq_idx, pk.lag_idx)], pk.value.cpu().numpy()))
    return out


def cell_lattice2(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import batched_stein_peaks, resolution_cell

    needles, hays, freqs, _, truths = build_lattice2(**shape)
    ns, hs = _on(needles, dev), _on(hays, dev)
    num = LATTICE_SLOTS["lattice2"]
    ef, el = resolution_cell(needles[0], freqs, FS)
    step = float(freqs[1] - freqs[0])

    def call():
        return batched_stein_peaks(ns, hs, freqs, FS, num, device=dev)

    def gate():
        # Each emitter within one resolution cell: in equal-length pairs
        # each mainlobe carries the other emitter's cross-ambiguity
        # sidelobe, which can move the exact maximum by a bin; the first
        # and last pairs are held to the cuFFT surface's lattice row for
        # row, values rtol 2e-5.
        fr, lg, vv = call()
        for i, want in enumerate(truths):
            rows = _rows(fr[i], lg[i], vv[i])
            _gate(all(any(abs(f - tf) <= ef * step and abs(x - tl) <= el
                          for f, x in rows) for tf, tl in want),
                  "lattice2", f"pair {i}: rows {rows}, want {want}")
        ends = [0, len(needles) - 1]
        for i, (w_rows, w_vals) in zip(ends, _lattice_oracle(
                ns, hs, freqs, num, ef, el, ends, dev)):
            got = [(float(f), int(x)) for f, x in zip(fr[i], lg[i])]
            rel = float(np.max(np.abs(vv[i] - w_vals) / np.abs(w_vals)))
            _gate(got == w_rows and rel <= 2e-5, "lattice2",
                  f"pair {i}: rows {got} / oracle {w_rows}, rel {rel:.3g}")

    return Cell("lattice2", f"{len(needles)}x{len(freqs)}x"
                            f"{2 * needles.shape[1]}", dev, gate,
                [Engine("stein", call)], _reduced(build_lattice2, shape))


def cell_lattice4(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import (batched_overlap_save_peaks_local,
                                       batched_stein_os_peaks)

    needles, hays, freqs, lags, truths = build_lattice4(**shape)
    ns, hs = _on(needles, dev), _on(hays, dev)
    num = LATTICE_SLOTS["lattice4"]
    engines = [
        Engine("stein", lambda: batched_stein_os_peaks(
            ns, hs, freqs, FS, num, num_lags=lags, device=dev)),
        Engine("cufft_lattice_scan", lambda: batched_overlap_save_peaks_local(
            ns, hs, freqs, FS, num, num_lags=lags, device=dev))]

    def gate():
        for e in engines:
            fr, lg, vv = e.call()
            for b, want in enumerate(truths):
                rows = set(_rows(fr[b], lg[b], vv[b]))
                _gate(set(want) <= rows, "lattice4",
                      f"{e.name} pair {b}: rows {sorted(rows)}, want {want}")

    return Cell("lattice4", f"{len(needles)}x{len(freqs)}x{lags}", dev, gate,
                engines, _reduced(build_lattice4, shape))


def cell_rate3(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import (rate_overlap_save_peak,
                                       stein_rate_os_peak)

    needle, hay, freqs, rates, lags, truths = build_rate3(**shape)["rate3"]
    n, h = _on(needle, dev), _on(hay, dev)
    engines = [
        Engine("stein", lambda: stein_rate_os_peak(
            n, h, freqs, rates, FS, num_lags=lags, device=dev)),
        Engine("serial_scan", lambda: rate_overlap_save_peak(
            n, h, freqs, rates, FS, num_lags=lags, device=dev))]

    def gate():
        for e in engines:
            got = e.call()
            _gate(tuple(got[:3]) == truths[0], "rate3",
                  f"{e.name} {got[:3]}, want {truths[0]}")

    return Cell("rate3", f"1x{len(freqs)}x{lags}_r{len(rates)}", dev, gate,
                engines, _reduced(build_rate3, shape))


def cell_ratelat3(dev, **shape) -> Cell:
    from caf_cookoff_tpu_torch import (rate_overlap_save_peaks,
                                       stein_rate_os_peaks)

    needle, hay, freqs, rates, lags, truths = build_rate3(**shape)[
        "ratelat3"]
    n, h = _on(needle, dev), _on(hay, dev)
    num = LATTICE_SLOTS["ratelat3"]

    def call():
        return stein_rate_os_peaks(n, h, freqs, rates, FS, num,
                                   num_lags=lags, device=dev)

    def rows(out):
        return [(float(r), float(f), int(x))
                for r, f, x, v in zip(*out[:4]) if np.isfinite(v)]

    def gate():
        got = rows(call())
        serial = rows(rate_overlap_save_peaks(n, h, freqs, rates, FS, num,
                                              num_lags=lags, device=dev))
        _gate(got[:2] == serial[:2] == truths, "ratelat3",
              f"rows {got}, serial {serial}, want {truths}")

    return Cell("ratelat3", f"1x{len(freqs)}x{lags}_r{len(rates)}", dev,
                gate, [Engine("stein", call)], _reduced(build_rate3, shape))


def _stream(capture, needle, freqs, dev, chunk, **kw):
    """A whole stream: build it, feed ``capture`` chunk by chunk."""
    from caf_cookoff_tpu_torch import StreamingCAF

    s = StreamingCAF(needle, freqs, FS, chunk_len=chunk, device=dev, **kw)
    for i in range(0, capture.shape[-1], chunk):
        s.process(capture[i:i + chunk])
    return s


def cell_stream3(dev, chunk: int = STREAM_CHUNK, **shape) -> Cell:
    needle, hay, two, freqs, truth, truths2 = build_stream3(**shape)
    n, h, h2 = _on(needle, dev), _on(hay, dev), _on(two, dev)
    num = LATTICE_SLOTS["stream3"]
    rate = _samples_per_s(len(hay))
    engines = [
        Engine("stein_stream", lambda: _stream(
            h, n, freqs, dev, chunk, backend="stein").best(), rate),
        Engine("cufft_stream", lambda: _stream(
            h, n, freqs, dev, chunk).best(), rate),
        Engine("stein_lattice_stream", lambda: _stream(
            h2, n, freqs, dev, chunk, backend="stein",
            num_peaks=num).peaks(), rate)]

    def gate():
        for e in engines[:2]:
            got = e.call()
            _gate(tuple(got[:2]) == truth, "stream3",
                  f"{e.name} {got[:2]}, want {truth}")
        rows = _rows(*engines[2].call())
        _gate(rows[:2] == truths2, "stream3",
              f"stein_lattice_stream rows {rows}, want {truths2}")

    red = _reduced(build_stream3, shape) + (
        [f"chunk={chunk} (full {STREAM_CHUNK})"] if chunk != STREAM_CHUNK
        else [])
    return Cell("stream3", f"{len(freqs)}x{len(hay)}", dev, gate, engines,
                red)


def cell_wide1000(dev, step_hz: float = 5.0, data_dir=ROOT / "data"
                  ) -> Cell:
    from caf_cookoff_tpu_torch import FreqGrid, caf_peak

    needle, hay = _chirp0(data_dir)
    freqs = FreqGrid(-1000.0, 1000.0, step_hz).frequencies(np.float32)
    n, h = _on(needle, dev), _on(hay, dev)

    def call():
        return caf_peak(n, h, freqs, FS, backend="stein", device=dev)

    def gate():
        got = call()
        want = caf_peak(n, h, freqs, FS, backend="xla", device=dev)
        _gate(got[:2] == want[:2] and got[1] == 202
              and abs(got[2] / want[2] - 1.0) <= 1e-4, "wide1000",
              f"stein {got}, xla {want}")

    return Cell("wide1000", f"{len(freqs)}x{2 * len(needle)}", dev, gate,
                [Engine("stein", call)],
                [f"step_hz={step_hz} (full 5.0)"] if step_hz != 5.0 else [])


def cell_stream1000(dev, chunk: int = STREAM_CHUNK, bins: int = 2000,
                    **shape) -> Cell:
    needle, hay, _, _, truth, _ = build_stream3(**shape)
    freqs = np.linspace(-1000, 1000, bins, endpoint=False).astype(
        np.float32)
    n, h = _on(needle, dev), _on(hay, dev)

    def call():
        return _stream(h, n, freqs, dev, chunk, backend="stein").best()

    def gate():
        got = call()
        _gate(tuple(got[:2]) == truth, "stream1000",
              f"stein_stream {got[:2]}, want {truth}")

    red = _reduced(build_stream3, shape) + [
        f"{a}={v} (full {d})" for a, v, d in (("chunk", chunk, STREAM_CHUNK),
                                              ("bins", bins, 2000)) if v != d]
    return Cell("stream1000", f"{bins}x{len(hay)}", dev, gate,
                [Engine("stein_stream", call, _samples_per_s(len(hay)))],
                red)


CELLS = {"config1": cell_config1, "config2": cell_config2,
         "config3": cell_config3, "config4": cell_config4,
         "config5": cell_config5, "lattice2": cell_lattice2,
         "lattice4": cell_lattice4, "rate3": cell_rate3,
         "ratelat3": cell_ratelat3, "stream3": cell_stream3,
         "wide1000": cell_wide1000, "stream1000": cell_stream1000}


def build_cells(names, device="cuda", shapes: Optional[Dict] = None
                ) -> List[Cell]:
    """The named cells on ``device`` (full width unless ``shapes[name]``
    gives a builder's shape arguments)."""
    dev = torch.device(device)
    shapes = shapes or {}
    return [CELLS[name](dev, **shapes.get(name, {})) for name in names]


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _event_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events: its answer is on the
    host when it returns, so its host time is inside."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")


def _device_work(fn, runs: int = 1):
    """(device ms, device operations, host syncs, host<->card copies) of
    one call of ``fn``: the kernels, memsets and copies of a
    ``torch.profiler`` trace of ``runs`` calls, summed and counted, the
    runtime's synchronising calls and the HtoD / DtoH copies counted,
    each over ``runs``.  Syncs are counted inside the calls' window only:
    the profiler and the trace's closing synchronise add their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("_device_work.calls"):
            for _ in range(runs):
                fn()
        torch.cuda.synchronize()
    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == "_device_work.calls"
                  and e.device_type == DeviceType.CPU)
    # The range's own device-side copy spans the calls' kernels: not one.
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "_device_work.calls"]
    field = ("self_device_time_total" if ops and hasattr(
        ops[0], "self_device_time_total") else "self_cuda_time_total")
    us = sum(getattr(e, field) for e in ops)
    syncs = sum(e.name in _SYNCS
                and window.start <= e.time_range.start <= window.end
                for e in events if e.device_type == DeviceType.CPU)
    copies = sum(e.name.startswith(("Memcpy HtoD", "Memcpy DtoH"))
                 for e in ops)
    return us / 1e3 / runs, len(ops) / runs, syncs / runs, copies / runs


def _commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def _source_digest() -> str:
    """sha256 of the package's sources (.py and .cu): tells two trees
    apart where there is no git."""
    h = hashlib.sha256()
    pkg = ROOT / "caf_cookoff_tpu_torch"
    for p in sorted(pkg.rglob("*")):
        if p.suffix in (".py", ".cu"):
            h.update(p.relative_to(pkg).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _metric(cell: Cell, engine: Engine) -> str:
    return f"cuda_{cell.name}_{cell.shape}_{engine.name}_call_ms"


def measure(cells: List[Cell], rounds: int = ROUNDS, *,
            warmup: int = WARMUP, timer=None, work=None,
            card: Optional[str] = None) -> List[Dict]:
    """Gate every cell, warm up, time ``rounds`` interleaved rounds,
    profile: one line per (cell, engine), and one ``"timed": false`` line
    per untimed cell.  ``timer(fn) -> ms`` and ``work(fn) -> (device ms,
    device operations, host syncs, host<->card copies)`` default to CUDA
    events and ``torch.profiler``,
    which refuse a device other than a CUDA card."""
    from caf_cookoff_tpu_torch.utils.bench import _require_card, \
        nvidia_smi_card

    if timer is None:
        for c in cells:
            _require_card(c.device)
        timer, work = _event_ms, _device_work
        card = card or nvidia_smi_card() or (
            torch.cuda.get_device_name(cells[0].device) if cells else None)
    for c in cells:
        c.gate()
    timed = [(c, e) for c in cells if c.timed for e in c.engines]
    for _, e in timed:
        for _ in range(warmup):
            e.call()
    samples: Dict[str, List[float]] = {_metric(c, e): [] for c, e in timed}
    captures = dict.fromkeys(samples, 0)
    for r in range(rounds):
        k = r % max(len(timed), 1)
        for c, e in timed[k:] + timed[:k]:
            before = _graph.CAPTURES
            samples[_metric(c, e)].append(timer(e.call))
            captures[_metric(c, e)] += _graph.CAPTURES - before
    common = {"card": card, "commit": _commit(), "source": _source_digest()}
    lines = []
    for c in cells:
        if not c.timed:
            lines.append({**_gate_line(c), **common})
            continue
        for e in c.engines:
            ms = samples[_metric(c, e)]
            med = statistics.median(ms)
            dev_ms, dev_ops, syncs, copies = work(e.call)
            lines.append({
                "metric": _metric(c, e), "value": med, "unit": "ms",
                "cell": c.name, "engine": e.name, "best_ms": min(ms),
                "median_ms": med, "spread_ms": max(ms) - min(ms),
                "rounds": len(ms), "device_ms": dev_ms,
                "device_ops": dev_ops, "host_share": 1.0 - dev_ms / med,
                "syncs": syncs, "copies": copies,
                "captures": captures[_metric(c, e)],
                **e.units(med), "gate": "passed", "reduced": c.reduced,
                **common})
    return lines


def _gate_line(c: Cell) -> Dict:
    return {"metric": f"cuda_{c.name}_{c.shape}_gate", "cell": c.name,
            "timed": False, "gate": "passed", "device": str(c.device),
            "reduced": c.reduced}


def gate_only(cells: List[Cell]) -> List[Dict]:
    """Every cell's gate on its device, nothing timed."""
    for c in cells:
        c.gate()
    return [_gate_line(c) for c in cells]


def headline(line: Dict) -> Dict:
    """``bench.py``'s one line from config 1's line."""
    return {"metric": "cuda_caf_surface_peak_400x8192_ms",
            "value": line["value"], "unit": "ms",
            "vs_baseline": BASELINE_MS / line["value"],
            **{k: line[k] for k in ("best_ms", "median_ms", "spread_ms",
                                    "rounds", "device_ms", "device_ops",
                                    "host_share", "card", "commit",
                                    "source", "reduced")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Gate, then time in interleaved rounds, the port's "
                    "cells on a CUDA card: one JSON line per (cell, "
                    "engine).")
    ap.add_argument("cells", nargs="*", choices=list(CELLS) + ["headline"],
                    help="cells to run (default: all); 'headline' prints "
                         "config 1's line with vs_baseline")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (timed) or 'cpu' (gates only)")
    ap.add_argument("--out", default=None,
                    help="also write every line into this JSON document")
    ap.add_argument("--config5-rank", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shape", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.config5_rank:
        return _config5_rank(args.device, json.loads(args.shape))
    is_headline = args.cells == ["headline"]
    if "headline" in args.cells and not is_headline:
        ap.error("'headline' runs alone")
    names = ["config1"] if is_headline else args.cells or list(CELLS)
    try:
        cells = build_cells(names, args.device)
        if torch.device(args.device).type == "cuda":
            lines = measure(cells, args.rounds)
        else:
            lines = gate_only(cells)
    except GateError as exc:
        print(f"bench_configs: gate failed: {exc}", file=sys.stderr)
        return 1
    if is_headline and lines[0].get("timed", True):
        lines = [headline(lines[0])]
    for line in lines:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lines": lines}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
