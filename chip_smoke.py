#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``caf_cookoff_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device — fails unless torch sees a CUDA card; prints the card and
   ``nvidia-smi``'s name and power limit; TF32 off for matmuls and cuDNN.
2. build  — compiles every ``csrc/*.cu`` of this checkout, one nvcc
   process per source, all at once, then one link, printing ``-Xptxas
   -v`` (registers, shared memory, spills).
3. kernel — each kernel against its plain PyTorch version on the card:
   K1, the fused Stein rank, held to ``rank_bound_check`` (its stage B
   sums on the tensor cores in their own order: each value within its
   error bound of the f64 stage B on the plain version's G, which is the
   kernel's bit for bit, each lag's f64 value within the bounds of the
   bin's f64 max; the largest |err|/e and the lags off the plain f32
   argmax printed), at chirp_0's main-path shape (400 bins, N = 4096,
   M = 8192, D = 64), a random two-pair shape and the cross-tile tie
   case (lowest lag wins, exactly); K2, the fused
   filterbank peak rows, at chirp_0's 400 x 8192, a random K = 37,
   M = 2048 shape, N = 5000 (M = 16384), an all-zero input (every lag
   ties: lag 0 wins, also at M = 16, one thread a bin), the grid M in
   {2, 8, 16, 1024, 8192, 16384, 32768, 131072} x K in {1, 8, 400}
   (K x M <= 400 x 32768; one thread, or 1 to 16 blocks, a bin),
   the refine tier's K = 8 and ties at 1, 2, 8 and 16 blocks a bin
   (all-zero: lag 0; two needle copies that different blocks hold: one
   of them); K3, the fused filterbank surface, at 400 x 8192 and the
   same grid.
3a. rescore — K5, the Stein engines' exact re-score, at the benchmark
   cells' three shapes as the engines call it (chirp_0 on the bench grid
   at P = 1; config 2's 64 pairs; config 3's capture, 2000 bins banded,
   a lag bound): (bin, lag) equal to its plain chain's (today's torch and
   cuFFT chain), values within FB_RTOL; its wrapper, device and
   graph-replayed ms and device operations a call beside the plain
   chain's, eager and replayed in a CUDA graph (``library``), and its
   bound.  From here on each path sets K5's call count to 0 with K1's
   and reads it after: one call a search of the Stein engines (the
   goldens, configs 2-4, wide1000, the one-rank ``parallel`` config 2
   and 3), none on the streams, the lattices and the rate engines;
   K5's entry reports the counts by path.
4. main   — the ten golden fixtures through ``caf_peak(device="cuda")``
   with ``backend="stein"`` (K1) and ``pallas``, ``pallas-bf16``,
   ``pallas-refine`` (K2): every answer exact, and each kernel's launch
   count, set to 0 just before and read just after, shows the path went
   through it; chirp_0 also through the cuFFT filterbank
   (``backend="xla"``) and the CPU route, and chirp_0's
   ``caf_surface(backend="pallas")`` (K3) against ``backend="xla"``; a
   16384-sample needle (M = 32768) through every ``pallas*`` backend and
   ``caf_surface(backend="pallas")``, against ``backend="xla"``.
5. modes  — K1 in modes (c) ``share_h`` (6 bands), (d) ``windows`` +
   ``num_valid`` (8 windows, the last one cut to half its lags) and (c+d)
   (48 programs) held to its bound, at config 3's full shape as its
   engine builds the operands.
6. configs — ``bench_configs.py`` configs 2-4 at full size through the
   public engines on the card, each gated as that script gates it:
   config 2 (64 pairs x 400 bins x 8192 lags, ``batched_stein_peak``)
   must equal single-pair ``stein_caf_peak`` for pairs 0, 13, 26, 39, 52;
   configs 3 (2000 bins x 65536 lags, 6 bands x 8 windows) and 4 (16
   pairs x 1024 bins x 32768 lags, 6 bands x 4 windows) through
   ``batched_stein_os_peak`` must recover every injected (freq, lag).
   K1's launch count, set to 0 before each config, must rise, every
   launch through K1's pipelined launch (``PIPELINED_LAUNCHES``); the
   stream3 phase checks that the Stein stream takes none.
6a. graph — the compiled calls (``ops/_graph``: one CUDA graph per
   static key, as ``jax.jit`` compiles one program) against their eager
   cores, bit for bit (value bits, bin, lag): the goldens, config1,
   wide1000 and a banded +-3000 Hz grid through ``stein_caf_peak``'s
   plan, config2 and its banded batch through ``batched_stein_peak``'s;
   the eager cores raise nothing under ``set_sync_debug_mode("error")``;
   a second grid of config1's shape replays without a capture; the
   public calls' syncs and host<->card copies (``torch.profiler``: one
   sync, the answer's read); each key's capture ms and pool memory; a
   replay's device time by the profiler within CUDA events' time of it.
   Then the streams and the windowed engines: stream3's Stein, cuFFT and
   Stein-lattice streams and stream1000's Stein stream chunk by chunk
   with ``best()`` / ``peaks()``, and ``batched_stein_os_peak`` at
   configs 3 and 4 on their grids (banded) and on +-100 Hz (one band):
   every compiled call — each step, the re-score, the needle spectra,
   the windowed cores — against its eager core bit for bit, the eager
   core under ``set_sync_debug_mode("error")``; a second stream of the
   same shapes (other values) captures nothing; syncs a whole run
   (at most 12) and a chunk (one) and a windowed call (one); the device
   operations and time of a chunk; each new key's capture ms and pool.
7. kernel — K1's top-2 mode (e) held to its bound in both slots, at the
   lattice shapes of phase 8 and in adversarial cases: a same-bin pair
   1.5 sep apart across a tile edge with the stronger's skirt in the
   other tile, exact ties between a recomputed tile and a tile-pass
   tile (at 2B = 8, and at 2B = 128 with the partner below and above:
   the lower lag wins, exactly), a window bounded to 0 lags and a sep
   past every lag.
8. lattices — the multi-emitter lattices at full width: config 2's shape
   (64 pairs x 400 bins x 8192 circular lags, two emitters a pair in
   bins 200 apart) through ``batched_stein_peaks`` (K1 (b+e), 64
   programs), pairs 0 and 63 held to ``find_peaks`` on
   ``caf_surface(backend="xla")``; config 4's multi-emitter recipe
   (``docs/bench_multi_emitter.py``: 16 pairs x 1024 bins x 32768 lags,
   two emitters a pair, 3 slots) through ``batched_stein_os_peaks``
   (banded, K1 (c+d+e), 384 programs), every pair's two emitters among
   its rows, pairs 0 and 15 held to the cuFFT lattice scan
   ``batched_overlap_save_peaks_local``.  K1's launch count, set to 0
   before each path, must rise.
9. rate   — K1 mode (f) (rate-major synthesis rows, 9 rates x 306-bin
   bands = 2754 rows, 56 programs) at rate3's full shape held to its
   bound, in (c+d+f) and (c+d+e+f); then
   the rate workloads through the public engines: rate3
   (``docs/bench_rate.py``'s recipe) through ``stein_rate_os_peak`` and
   the serial ``rate_overlap_save_peak``, both exact, then
   ``refine_peak_rate`` within 0.1 Hz/s and 0.1 samples; ratelat3 (a
   second emitter) through ``stein_rate_os_peaks``, its emitters the
   first two rows and equal to ``rate_overlap_save_peaks``'; rate1 (a
   needle-length window) through ``rate_caf_peak`` (cuFFT, no kernel).
   K1's launch count, set to 0 before each segmented path, must rise.
10. refine — the ten goldens through ``refine_peak`` on the card, within
   0.01 Hz and 0.1 samples of the injected truth.
11. stream — stream3, config 3's capture in 8192-sample chunks (the last
   4096, so K1 masks it with ``num_valid``), through ``StreamingCAF``:
   the Stein stream (K1 at P = 1 a chunk) equal to
   ``stein_overlap_save_peak`` and the truth, the cuFFT stream the same;
   a two-emitter version through the Stein stream's 3-slot lattice (K1
   (e) a chunk), both emitters its first two rows and equal to
   ``overlap_save_peaks``; K1's launch count, set to 0 before each Stein
   path, one a chunk; the last chunk's K1 launch held to its bound, with
   ``num_valid`` and with top-2; the CLI ``stream`` verb on chirp_0.
12. rows   — K1 past one block's shared memory, G's rows shared over a
   thread-block cluster a lag tile: random operands at 2B = 1024, 1536
   and 1872 (D = 8; clusters of 2, 3 and 3) in modes (a), (b), (c+d),
   (e) and (f), each held to its bound and counted as a split launch;
   wide1000, chirp_0 through ``caf_peak(backend="stein")`` over -1000 ...
   +995 Hz step 5 (D = 8, 2B = 1024), equal to ``backend="xla"``'s
   (freq, lag), one split K1 launch; config 3's capture through a
   +-1000 Hz (step 1) Stein stream, one split K1 launch a chunk, equal to
   the cuFFT stream's answer and the truth.
13. parallel — ``parallel/`` on the card.  A world of one rank on NCCL
   (a 1 x 1 x 1 mesh) in this process runs the four engines with K1 in
   each shard at their full cells — ``sharded_batched_stein_peak`` at
   config 2, ``sharded_stein_os_peak`` at config 3,
   ``sharded_batched_stein_os_peaks`` at lattice4 and
   ``sharded_stein_rate_os_peak`` at rate3 — each bit for bit the
   single-device engine, K1's launch count (set to 0 before each) rising;
   then each whole call at one rank against its single-device engine,
   interleaved.  Then eight ranks on the one card (``python3 chip_smoke.py
   --parallel-rank``, started by ``multihost.launch_local`` after the
   build, each computing on ``cuda:0`` with gloo collectives, as NCCL
   takes one rank a card) as config 5's mesh (pair=2 x doppler=2 x
   time=2): config 5 (``bench_configs.py:359-382``, 8 pairs x 64 bins x
   16384 lags) through ``batched_overlap_save_peak`` with every emitter
   recovered, config 3 through ``sharded_stein_os_peak`` over time=8 and
   config 2 through ``sharded_batched_stein_peak`` over pair=8, each equal
   to the single-device answers, each rank's K1 count rising; a rank
   that exits non-zero fails the run.  Its wall time is that of ranks
   sharing one card, not a scaling number.
14. K4     — the epilogue microbenchmark (``utils/roofline``) against its
   plain version bit for bit, then ``roofline.measure`` (its launch
   count, set to 0 before, must rise).
15. times  — CUDA-event medians, after warm-up, of each kernel's wrapper,
   its plain version and its library yardstick at the main path's
   shape (K1's: stage B alone as one bf16 ``torch.matmul``, at every K1
   shape; K1's device time from ``torch.profiler`` too), of K1 at each
   config's shape (where it is first held to its bound as in phase 3;
   its device time and the launch it took, pipelined or tile),
   of K1(e) at both lattice shapes, of K1 (f) and (e+f) at rate3's, of
   K4 (bound: its non-fma operations at half the f32 peak), and of
   K2/K3's launches alone (ten back to back from Python) and as device
   time (replays of a CUDA graph of ten), both also for K2 at the refine
   tier's K = 8, K2's device time at one full wave of bins, K2/K3's
   blocks a SM, cluster size and waves at 400 x 8192, K1 at stream3's
   chunk shape, one ``process`` call a chunk (and its device time and
   device operations), whole streams and their samples a second, K1 at
   2B = 1024, 1536 and 1872 (K = 400, 8192 lags: wrapper, device time,
   plain, bound, library), the wide1000 call and the +-1000 Hz stream, whole
   ``caf_peak``, config, lattice, rate-engine, refine and
   ``stein_overlap_save_peak`` calls and the cuFFT yardsticks (host
   included), each printed beside the card's name and power limit.
16. bench  — the port's benchmark (``python -m
   caf_cookoff_tpu_torch.utils.bench_configs``) over every cell at full
   width in 3 interleaved rounds, in a child process: every cell's gate
   must pass, then one ``[bench]`` line a (cell, engine) with its
   median, best and spread, device time and host share, and no graph
   captured during the timed rounds.
17. scaling — the scaling harness (``utils/bench_scaling``) at N = 1 on
   NCCL in a child process, ``doppler`` and ``time``: gated and timed,
   no efficiency (one card gives no scaling number).
18. fault2 — partial-overlap workloads (the needle only partly reaches
   the haystack) through ``caf_peak(backend="stein")`` on the card and
   ``backend="xla"``, both (freq, lag) printed, not gated: K1 rounds its
   weights to bf16 as the TPU kernel does, and on surfaces this flat the
   coarse rank can miss.

Then a JSON line describing each kernel (with its bound from this run's
shapes), and as the last line ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero without that line.  Fixtures are generated
into ``data/`` when missing.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
FS = 48_000.0
# K1 is held to ops/fused_stein.rank_bound_check: its stage B sums on
# the tensor cores in their own order, so each |R|^2 is held to the f64
# stage B on the plain version's G within a stated error bound.
# K2/K3 vs plain versions: two f32 FFT algorithms (the kernel's
# register-radix passes, cuFFT) that differ in the order of their sums,
# so near-ties may order differently.
LAG_SHARE = 0.99    # K2: least share of bins whose lag equals the plain one
FB_RTOL = 1e-5      # per-bin peak values; the plain value at the kernel's lag
FB_SURF_TOL = 1e-5  # surface max abs error, as a share of the surface max
# H100 SXM peaks at 700 W (NVIDIA's data sheet): dense bf16 tensor cores,
# f32 outside the tensor cores, HBM3.
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12
GOLDEN = [          # (chirp index, (start, stop, step) Hz, freq, lag)
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
# K2's tie cases: (M, K) at clusters of 1, 2, 8 and 16 blocks a bin.
TIE_SHAPES = ((2048, 17), (16384, 8), (65536, 2), (131072, 1))
# Launches of the pallas* filterbank kernel per caf_peak call.
PALLAS_LAUNCHES = {"pallas": 1, "pallas-bf16": 1, "pallas-refine": 2}
# K5's calls by path (ops/stein_rescore.RESCORE_LAUNCHES, set to 0 before
# each path with K1's counter), for K5's entry: one a search of the Stein
# engines, none on the streams, the lattices and the rate engines.
RESCORE_BY_PATH = {}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def reset_rescore():
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    rs.RESCORE_LAUNCHES = 0


def rescore_calls(path, want):
    """K5's calls on ``path`` since :func:`reset_rescore`, gated to
    ``want`` and kept in ``RESCORE_BY_PATH``."""
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    got = RESCORE_BY_PATH[path] = rs.RESCORE_LAUNCHES
    print(f"[rescore] {path}: K5 calls {got} (want {want})")
    check(got == want, f"{path}: {got} K5 calls, want {want}")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from caf_cookoff_tpu_torch.utils.bench import nvidia_smi_card

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_card()
    check(smi is not None, "nvidia-smi gave no name and power limit")
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    print(smi)
    return name, smi


def import_port():
    sys.path.insert(0, str(ROOT))
    try:
        import caf_cookoff_tpu_torch
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: the port is not beside this script: "
                         f"{exc}")
    check(Path(caf_cookoff_tpu_torch.__file__).resolve().parents[1] == ROOT,
          "caf_cookoff_tpu_torch imported from outside this checkout")


def phase_build() -> float:
    from caf_cookoff_tpu_torch.ops import _build

    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.build_library(verbose=True)
    _build.load_library()
    seconds = time.perf_counter() - t0
    how = "found in the build cache" if cached else "built with nvcc"
    names = ", ".join(src.name for src in _build.SOURCES)
    print(f"[build] {names} {how} and loaded in {seconds:.1f} s")
    return seconds


def load_pair(pairs, idx):
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle = load_c64(pairs[idx][0])
    return needle, load_c64(pairs[idx][1], count=len(needle))


def headline_operands(needle, haystack, device):
    """chirp_0's fused-rank operands as the main path builds them."""
    import torch

    from caf_cookoff_tpu_torch.config import BENCH_GRID, xcor_length
    from caf_cookoff_tpu_torch.models.stein import _fused_operands

    freqs = torch.from_numpy(BENCH_GRID.frequencies(np.float32)).to(device)
    m = xcor_length(len(needle))
    ops, b, sup = _fused_operands(
        torch.from_numpy(needle).to(device),
        torch.from_numpy(haystack).to(device), freqs, FS, m, 64)
    return ops, b, sup, m


def random_operands(rng, p, n, k, m, d, device):
    import torch

    from caf_cookoff_tpu_torch.models.batched_stein import (
        _haystack_extension, _needle_operator)
    from caf_cookoff_tpu_torch.ops.fused_stein import (
        fused_span, stein_synthesis_weights)

    def cplx(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(device)

    lmat, sup = _needle_operator(cplx((p, n)), cplx((p, n)), d)
    span = fused_span(n // d, sup, m)
    h_ext = _haystack_extension(cplx((p, n)), cplx((p, n)), m, span)
    freqs = torch.linspace(-200.0, 200.0, k, device=device)
    ws1, ws2 = stein_synthesis_weights(freqs, FS, n // d, d)
    return (ws1, ws2, lmat, h_ext), n // d, sup, m


def surface_plain(ops, b, sup, m, **modes):
    """K1's plain version as every plain time here times it: the masked
    (P_eff, K, m_pad) surface with the kernel's bf16 roundings, G summed
    in the kernel's order (bit for bit), stage B row by row."""
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    return fs.coarse_surface_plain(*ops, b, sup, m, emulate_bf16=True,
                                   **modes)


def bound_check(label, got, ops, b, sup, m, sep=None, **modes):
    """K1's answer ``got`` held to ``rank_bound_check``: the f64 stage B
    on the plain version's G (the kernel's bit for bit), each value
    within its bound e of v* at the kernel's lag, and v* there within the
    two lags' bounds of the bin's f64 max (slot 2: outside the window
    around slot 1's lag, or the (-1.0, 0) sentinel).  Prints the largest
    |err| / e and the lags off the plain f32 surface's (non-zero only at
    near-ties); returns the max absolute value error."""
    import torch

    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got[::2]),
          f"{label}: non-finite values")
    r = fs.rank_bound_check(got, *ops, b, sup, m, sep=sep, **modes)
    top2 = "" if sep is None else f" sep={sep} (both slots)"
    print(f"[kernel] {label}: K={got[0].shape[0]} P={got[0].shape[1]} "
          f"M={m}{top2}: largest |err|/e {r['ratio']:.3e} (bound c = "
          f"{fs.BOUND_C:g}, want <= 1), lag gap / bounds "
          f"{r['lag_ratio']:.3e} (want <= 1), max abs err "
          f"{r['max_abs_err']:.4g}; lags off the plain f32 argmax "
          f"{r['lags_off_f32']} of {r['n']}")
    check(r["ok"], f"{label}: kernel off its error bound")
    return r["max_abs_err"]


def compare(label, ops, b, sup, m, **modes):
    """K1 on one operand set (``modes``: windows, share_h, num_valid)
    through :func:`bound_check`; returns the max absolute value error."""
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    return bound_check(label, fs.fused_stein_rank(*ops, b, sup, m, **modes),
                       ops, b, sup, m, **modes)


def phase_kernel_stein(pairs):
    import torch

    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    n0, h0 = load_pair(pairs, 0)
    head = headline_operands(n0, h0, DEVICE)
    err = compare("K1 chirp_0 headline", *head)
    rng = np.random.default_rng(0)
    compare("K1 random P=2", *random_operands(rng, 2, 2048, 97, 4096, 32,
                                              DEVICE))
    # Two bit-identical needle copies at lags 100 and 3172 tie exactly.
    n, d, k, m = 512, 64, 17, 4096
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(3172 + n, np.complex64)
    hay[100:100 + n] = needle
    hay[3172:3172 + n] = needle
    from caf_cookoff_tpu_torch.models.batched_stein import (
        _haystack_extension, _needle_operator)

    nt = torch.from_numpy(needle).to(DEVICE)[None]
    ht = torch.from_numpy(hay).to(DEVICE)[None]
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _haystack_extension(ht.real, ht.imag, m,
                                fs.fused_span(n // d, sup, m))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-100.0, 100.0, k, device=DEVICE), FS, n // d, d)
    _, ki = fs.fused_stein_rank(ws1, ws2, lmat, h_ext, n // d, sup, m)
    tie_lag = int(ki[k // 2, 0])
    print(f"[kernel] K1 tie case: zero-doppler bin lag {tie_lag} (want 100)")
    check(tie_lag == 100, "cross-tile tie did not resolve to the lowest lag")
    return head, err


def compare_peak_rows(label, needle, hay, freqs, m):
    """K2 vs its plain version on the card; returns the max absolute
    value error."""
    import torch

    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    kv, ki = pc.pallas_peak_rows(needle, hay, freqs, FS, m)
    rows = pc._mag2(pc._rows_plain(needle, hay, freqs, FS, m))
    torch.cuda.synchronize()
    pv, pi = rows.max(dim=-1)
    check(bool(torch.isfinite(kv).all()) and int(ki.min()) >= 0
          and int(ki.max()) < m, f"{label}: values or lags out of range")
    rel = ((kv - pv).abs() / pv).max().item()
    at = torch.gather(rows, 1, ki.long()[:, None])[:, 0]
    lag_ok = bool((at >= (1 - FB_RTOL) * pv).all())
    share = (ki == pi).float().mean().item()
    err = (kv - pv).abs().max().item()
    print(f"[kernel] {label}: K={kv.shape[0]} N={needle.shape[-1]} M={m}: "
          f"max rel err {rel:.3e} (tol {FB_RTOL}), max abs err {err:.4g}, "
          f"plain value at kernel lag >= (1-{FB_RTOL}) x max: {lag_ok}, "
          f"exact lag matches {share:.4f} (least {LAG_SHARE})")
    check(rel <= FB_RTOL, f"{label}: kernel values off the plain version")
    check(lag_ok, f"{label}: kernel lag not a (near-)maximum")
    check(share >= LAG_SHARE, f"{label}: kernel lags off the plain argmax")
    return err


def random_pair(rng, n, lag, device):
    import torch

    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.roll(needle, lag) + 0.1 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (torch.from_numpy(needle).to(device),
            torch.from_numpy(hay.astype(np.complex64)).to(device))


def phase_kernel_filterbank(pairs):
    import torch

    from caf_cookoff_tpu_torch.config import BENCH_GRID, xcor_length
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    n0, h0 = load_pair(pairs, 0)
    needle = torch.from_numpy(n0).to(DEVICE)
    hay = torch.from_numpy(h0).to(DEVICE)
    freqs = torch.from_numpy(BENCH_GRID.frequencies(np.float32)).to(DEVICE)
    m = xcor_length(len(n0))
    head = (needle, hay, freqs, m)
    err_peak = compare_peak_rows("K2 chirp_0 headline", *head)
    rng = np.random.default_rng(1)
    compare_peak_rows("K2 random K=37", *random_pair(rng, 1000, 321, DEVICE),
                      torch.linspace(-900.0, 900.0, 37, device=DEVICE), 2048)
    compare_peak_rows("K2 N=5000", *random_pair(rng, 5000, 123, DEVICE),
                      torch.linspace(-100.0, 100.0, 20, device=DEVICE),
                      xcor_length(5000))
    # All-zero input: every lag of every bin ties at 0; the lowest wins.
    zero = torch.zeros(512, dtype=torch.complex64, device=DEVICE)
    _, zi = pc.pallas_peak_rows(zero, zero, freqs[:9], FS, 1024)
    print(f"[kernel] K2 all-lags tie: lags {sorted(set(zi.tolist()))} "
          f"(want [0])")
    check(zi.tolist() == [0] * 9, "K2 tie did not resolve to the lowest lag")
    # Rows under 32 points (one thread a bin, 70 bins: two blocks).
    zero = torch.zeros(8, dtype=torch.complex64, device=DEVICE)
    _, zi = pc.pallas_peak_rows(zero, zero, freqs[:70], FS, 16)
    print(f"[kernel] K2 all-lags tie at M=16: lags {sorted(set(zi.tolist()))} "
          f"(want [0])")
    check(zi.tolist() == [0] * 70,
          "K2 tie at M=16 did not resolve to the lowest lag")
    # The design's grid: rows of one thread (M < 32) and of 1 to 16 blocks
    # a bin (clusters past 8192 points), K x M capped at 400 x 32768.
    for mm in (2, 8, 16, 1024, 8192, 16384, 32768, 131072):
        for kk in (1, 8, 400):
            if kk * mm > 400 * 32768:
                continue
            compare_peak_rows(
                f"K2 grid (C={pc.cluster_size(mm)})",
                *random_pair(rng, mm // 2, 37 + mm // 7, DEVICE),
                torch.linspace(-300.0, 300.0, kk, device=DEVICE), mm)
            compare_surface(f"K3 grid (C={pc.cluster_size(mm)})",
                            *random_pair(rng, mm // 2, 11 + mm // 5, DEVICE),
                            torch.linspace(-300.0, 300.0, kk,
                                           device=DEVICE), mm)
    # The refine tier's second launch: chirp_0's 8 bins nearest its peak.
    near = torch.argsort((freqs - 69.25).abs())[:8].sort().values
    compare_peak_rows(f"K2 refine shape (C={pc.cluster_size(m)})",
                      needle, hay, freqs[near], m)
    phase_filterbank_ties(pc)
    err_surf = compare_surface("K3 chirp_0 headline", *head)
    return head, err_peak, err_surf


def compare_surface(label, needle, hay, freqs, m):
    """K3 vs its plain version on the card; returns the max absolute
    error."""
    import torch

    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    ks = pc.pallas_surface(needle, hay, freqs, FS, m)
    ps = pc.caf_surface_plain(needle, hay, freqs, FS, m)
    torch.cuda.synchronize()
    err = (ks - ps).abs().max().item()
    share = err / ps.max().item()
    print(f"[kernel] {label}: K={ks.shape[0]} M={ks.shape[1]}: max abs err "
          f"{err:.4g} = {share:.3e} x surface max (tol {FB_SURF_TOL})")
    check(ks.shape == ps.shape and bool(torch.isfinite(ks).all()),
          f"{label}: surface shape or values")
    check(share <= FB_SURF_TOL, f"{label}: surface off the plain version")
    return err


def phase_filterbank_ties(pc):
    """Ties at one block a bin and in bins split over clusters of 2, 8
    and 16 blocks: the all-zero input (every lag ties; each block's own
    lowest lag differs, the bin's is 0) and two needle copies at lags
    that different blocks hold (a near-tie: the lag is one of them, its
    plain value within FB_RTOL of the maximum)."""
    import torch

    rng = np.random.default_rng(11)
    for m, k in TIE_SHAPES:
        c = pc.cluster_size(m)
        freqs = 12.5 * (torch.arange(k, device=DEVICE) - k // 2)
        zero = torch.zeros(m // 2, dtype=torch.complex64, device=DEVICE)
        _, zi = pc.pallas_peak_rows(zero, zero, freqs, FS, m)
        lo, hi = 100, 100 + (m // c + m // c // c if c > 1 else m // 4)
        n = min(512, m // 8)
        needle = (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
        hay = np.zeros(m, np.complex64)
        hay[lo:lo + n] = needle
        hay[hi:hi + n] = needle
        nt = torch.from_numpy(needle).to(DEVICE)
        ht = torch.from_numpy(hay).to(DEVICE)
        _, li = pc.pallas_peak_rows(nt, ht, freqs, FS, m)
        rows = pc._mag2(pc._rows_plain(nt, ht, freqs, FS, m))
        mid = k // 2
        lag = int(li[mid])
        near = float(rows[mid, lag]) >= (1 - FB_RTOL) * float(rows[mid].max())
        print(f"[kernel] K2 ties M={m} K={k} C={c}: all-zero lags "
              f"{sorted(set(zi.tolist()))} (want [0]); copies at {lo} and "
              f"{hi}: lag {lag}, near the plain max: {near}")
        check(zi.tolist() == [0] * k,
              "K2 tie did not resolve to the lowest lag")
        check(lag in (lo, hi) and near, "K2 near-tie lag")


def rescore_inputs(pairs):
    """The three Stein engines' exact re-score calls as the engines make
    them, eagerly, at the benchmark cells' shapes: (name, args, kwargs)
    of ``ops/stein_rescore.stein_rescore`` for chirp_0 on the bench grid
    through ``stein_caf_peak``'s core (cookoff.single), config 2's 64
    pairs through ``batched_stein_peak``'s (cookoff.batch64) and config
    3's capture through ``batched_stein_os_peak``'s (widearea.capture:
    2000 bins banded, a lag bound)."""
    import torch

    from caf_cookoff_tpu_torch import BENCH_GRID
    from caf_cookoff_tpu_torch.models import batched_stein as tbs
    from caf_cookoff_tpu_torch.models import stein as tstein
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needle, hay = load_pair(pairs, 0)
    n0, h0 = (torch.from_numpy(x).to(DEVICE) for x in (needle, hay))
    ns, hs, freqs2 = bc.build_config2(pairs=64)[:3]
    cn, ch, freqs3, lags3 = bc.build_config3()[:4]
    on = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    plans = [
        ("cookoff.single", tstein, tstein._stein_call(
            n0, h0, BENCH_GRID.frequencies(np.float32), FS, 64, True, None,
            DEVICE)),
        ("cookoff.batch64", tbs, tbs._batched_call(
            on(ns), on(hs), freqs2, FS, 64, True, DEVICE)),
        ("widearea.capture", tbs, tbs._os_call(
            on(cn), on(ch), freqs3, FS, lags3, 64, DEVICE))]
    calls = []
    for name, module, (core, traced, static, *_) in plans:
        real, seen = module.stein_rescore, []

        def spy(*a, real=real, seen=seen, **kw):
            seen.append((a, kw))
            return real(*a, **kw)

        module.stein_rescore = spy
        try:
            core(*traced, *static)
        finally:
            module.stein_rescore = real
        check(len(seen) == 1, f"[rescore] {name}: one re-score a search")
        calls.append((name, *seen[0]))
    return calls


def rescore_bound_ms(args, kw):
    """K5: each (pair, candidate) row's two M-point transforms, 2 x 5 M
    log2 M FLOP, at the f32 peak, against the needles, the pairs'
    spectra, the ranking and the grid read once and the answers written
    once at the HBM rate.  Returns (ms, what bounds it, rows)."""
    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    ns, _, freqs, ranking, _, m, _, num_valid = args
    p = ranking.shape[0] if ranking.ndim == 2 else 1
    k = ranking.shape[-1]
    rows = p * sum(rs._num_picks(k, num_valid))
    flops = rows * 2 * 5.0 * m * math.log2(m)
    nbytes = 8.0 * ns.numel() + 8.0 * p * m + 4.0 * (p * k + freqs.numel()) \
        + 12.0 * p
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"), rows


def phase_rescore(pairs, card):
    """K5 against its plain chain (today's torch and cuFFT chain) at the
    cells' three shapes: the answers' (bin, lag) equal, the values
    within FB_RTOL; then, per shape, the wrapper's CUDA-event ms, its
    device ms and device operations a call (``torch.profiler``), its ms
    replayed in a CUDA graph (as the engines run it), the bound, and the
    plain chain's the same (its graph replay is the ``library`` time:
    the chain as the engines ran it before K5)."""
    import torch

    from caf_cookoff_tpu_torch.ops import stein_rescore as rs

    out = {}
    for name, args, kw in rescore_inputs(pairs):
        reset_rescore()
        got = rs.stein_rescore(*args, **kw)
        want = rs.rescore_plain(*args, **kw)
        torch.cuda.synchronize()
        check(rs.RESCORE_LAUNCHES == 1,
              f"[rescore] {name}: the call did not launch K5 once")
        same = (torch.equal(got.freq_idx, want.freq_idx)
                and torch.equal(got.lag_idx, want.lag_idx))
        rel = float(((got.value - want.value).abs()
                     / want.value.abs()).max())
        print(f"[rescore] {name}: (bin, lag) equal to the plain chain's: "
              f"{same}; max rel value err {rel:.3e} (tol {FB_RTOL})")
        check(same and rel <= FB_RTOL, f"[rescore] {name}: K5 off the "
              f"plain chain")
        k5 = lambda: rs.stein_rescore(*args, **kw)  # noqa: E731
        plain = lambda: rs.rescore_plain(*args, **kw)  # noqa: E731
        t = {"ms": cuda_median_ms(k5, 100), "plain_ms": cuda_median_ms(
            plain, 50), "graph_ms": graph_ms(k5),
             "library_ms": graph_ms(plain)}
        t["device_ms"], t["device_ops"] = device_work(k5)
        t["plain_device_ms"], t["plain_device_ops"] = device_work(plain)
        t["bound_ms"], t["bound_by"], t["rows"] = rescore_bound_ms(args, kw)
        out[name] = t
        print(f"[rescore] {name}: K5 wrapper {t['ms']:.4f} ms, in a graph "
              f"{t['graph_ms']:.4f}, device {t['device_ms']:.4f} ms in "
              f"{t['device_ops']:.1f} ops; plain chain {t['plain_ms']:.4f}"
              f" ms, in a graph (library) {t['library_ms']:.4f}, device "
              f"{t['plain_device_ms']:.4f} ms in {t['plain_device_ops']:.1f}"
              f" ops; bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
              f"{t['rows']} rows)  [{card}]")
    return out


def golden_inputs(pairs):
    from caf_cookoff_tpu_torch import FreqGrid

    inputs = []
    for idx, grid, want_f, want_l in GOLDEN:
        needle, hay = load_pair(pairs, idx)
        inputs.append((needle, hay, FreqGrid(*grid).frequencies(np.float32),
                       want_f, want_l))
    return inputs


def run_goldens(inputs, backend):
    from caf_cookoff_tpu_torch import caf_peak

    answers = [caf_peak(n, h, f, FS, backend=backend, device=DEVICE)
               for n, h, f, _, _ in inputs]
    for (idx, *_), (_, _, _, want_f, want_l), (freq, lag, val) in zip(
            GOLDEN, inputs, answers):
        print(f"[main] {backend} chirp_{idx}: {freq:+.3f} Hz, lag {lag}, "
              f"value {val:.6g} (want {want_f:+.3f} Hz, lag {want_l})")
        check(abs(freq - want_f) <= 1e-4 and lag == want_l
              and np.isfinite(val) and val > 0,
              f"{backend} chirp_{idx} answer")
    return answers


def phase_main_stein(inputs):
    from caf_cookoff_tpu_torch import caf_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    fs.LAUNCHES = 0
    reset_rescore()
    answers = run_goldens(inputs, "stein")
    launches = fs.LAUNCHES
    print(f"[main] fused_stein_rank launches over the 10 goldens: "
          f"{launches}")
    rescore_calls("stein goldens", len(GOLDEN))
    check(launches >= len(GOLDEN), "main path did not launch the kernel")
    n0, h0, f0, _, _ = inputs[0]
    stein0 = answers[0]
    fb = caf_peak(n0, h0, f0, FS, backend="xla", device=DEVICE)
    cpu = caf_peak(n0, h0, f0, FS, backend="stein", device="cpu")
    print(f"[main] chirp_0 cuFFT filterbank: {fb[0]:+.3f} Hz, lag {fb[1]}, "
          f"value {fb[2]:.6g}; CPU stein route: {cpu[0]:+.3f} Hz, lag "
          f"{cpu[1]}, value {cpu[2]:.6g}")
    check(fb[:2] == stein0[:2] == cpu[:2], "routes disagree on chirp_0")
    # Both exact values come from the same re-score rows: f32 FFTs in
    # another library and order.
    check(abs(fb[2] - stein0[2]) <= 1e-4 * fb[2]
          and abs(cpu[2] - stein0[2]) <= 1e-4 * cpu[2],
          "chirp_0 values disagree between routes")
    return launches, fb


def phase_main_pallas(inputs, fb):
    from caf_cookoff_tpu_torch import caf_surface
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    peak_launches = 0
    m = 8192
    for backend, per_call in PALLAS_LAUNCHES.items():
        pc.PEAK_LAUNCHES = 0
        answers = run_goldens(inputs, backend)
        launches = pc.PEAK_LAUNCHES
        print(f"[main] {backend}: caf_peak_rows launches over the 10 "
              f"goldens: {launches} (want {per_call * len(GOLDEN)})")
        check(launches == per_call * len(GOLDEN),
              f"{backend} did not launch the filterbank kernel per call")
        peak_launches += launches
        # The pallas* value is unnormalised: M^2 times the xla value.
        ratio = answers[0][2] / (fb[2] * m * m)
        print(f"[main] {backend} chirp_0 value / (M^2 x xla value) = "
              f"{ratio:.7f}")
        check(abs(ratio - 1.0) <= 1e-4, f"{backend} chirp_0 value scale")
    n0, h0, f0, _, _ = inputs[0]
    pc.SURFACE_LAUNCHES = 0
    got = caf_surface(n0, h0, f0, FS, backend="pallas", device=DEVICE)
    surface_launches = pc.SURFACE_LAUNCHES
    want = caf_surface(n0, h0, f0, FS, backend="xla", device=DEVICE)
    # The JAX package's bound for its pallas surface against its XLA one.
    bad = ((got - want).abs() > 1e-3 * want.abs()
           + 1e-4 * want.max()).sum().item()
    print(f"[main] chirp_0 caf_surface pallas vs xla: {got.shape[0]}x"
          f"{got.shape[1]}, cells off rtol 1e-3 + atol 1e-4 x max: {bad}; "
          f"caf_surface launches: {surface_launches}")
    check(surface_launches == 1, "caf_surface did not launch the kernel")
    check(bad == 0, "pallas surface disagrees with xla")
    phase_long_needle()
    return peak_launches, surface_launches


def phase_long_needle():
    """A 16384-sample needle (M = 32768: a cluster of blocks a bin, past
    the 16384 points one block held before) through ``caf_peak`` with
    every pallas backend and ``caf_surface(backend="pallas")``, against
    ``backend="xla"`` with the bounds above."""
    from caf_cookoff_tpu_torch import caf_peak, caf_surface

    rng = np.random.default_rng(8)
    n, lag, f_hz, m = 16384, 4321, 37.0, 32768
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (np.roll(needle, lag) * np.exp(2j * np.pi * f_hz * np.arange(n)
                                         / FS)).astype(np.complex64)
    freqs = np.arange(-100.0, 100.0, 1.0, dtype=np.float32)
    want = caf_peak(needle, hay, freqs, FS, backend="xla", device=DEVICE)
    for backend in PALLAS_LAUNCHES:
        got = caf_peak(needle, hay, freqs, FS, backend=backend,
                       device=DEVICE)
        ratio = got[2] / (want[2] * m * m)
        print(f"[main] {backend} 16384-sample needle (M = {m}): "
              f"{got[0]:+.3f} Hz, lag {got[1]} (xla {want[0]:+.3f} Hz, lag "
              f"{want[1]}; want {f_hz:+.3f}, {lag}), value / (M^2 x xla) = "
              f"{ratio:.7f}")
        check(got[:2] == want[:2] == (f_hz, lag)
              and abs(ratio - 1.0) <= 1e-4, f"{backend} at M = {m}")
    got = caf_surface(needle, hay, freqs, FS, backend="pallas",
                      device=DEVICE)
    ref = caf_surface(needle, hay, freqs, FS, backend="xla", device=DEVICE)
    bad = ((got - ref).abs() > 1e-3 * ref.abs()
           + 1e-4 * ref.max()).sum().item()
    print(f"[main] caf_surface pallas vs xla at M = {m}: {got.shape[0]}x"
          f"{got.shape[1]}, cells off rtol 1e-3 + atol 1e-4 x max: {bad}")
    check(got.shape == ref.shape and bad == 0,
          f"pallas surface disagrees with xla at M = {m}")


def config_inputs():
    """Configs 2-4 of ``bench_configs.py`` from the port's benchmark's
    builders (its recipes, copied byte for byte): name -> (needles,
    haystacks, freqs, num_lags or None, truths or None)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    return {"config2": bc.build_config2(), "config3": bc.build_config3(),
            "config4": bc.build_config4()}


def config_operands(cfg):
    """K1's operands as the config's engine builds them on the card:
    (ops, b, sup, num_lags, modes, shape label)."""
    import torch

    from caf_cookoff_tpu_torch.config import xcor_length
    from caf_cookoff_tpu_torch.models import batched_stein as bs
    from caf_cookoff_tpu_torch.models._stein_plan import (_plan_bands,
                                                          _pow2_block_len)
    from caf_cookoff_tpu_torch.ops.xcor import pad_to

    needles, hays, freqs, lags, _ = cfg
    ns = torch.from_numpy(needles).to(DEVICE)
    hs = torch.from_numpy(hays).to(DEVICE)
    n = ns.shape[-1]
    m = xcor_length(n)
    if lags is None:
        ft = torch.from_numpy(freqs).to(DEVICE)
        d = _pow2_block_len(FS, freqs, 64)
        ops, b, sup, modes = bs._batch_operands(pad_to(ns, n + (-n) % 128),
                                                hs, ft, FS, m, d)
        return ops, b, sup, m, modes, (f"K={len(freqs)} P={ns.shape[0]} "
                                       f"M={m} D={d}")
    plan = _plan_bands(FS, freqs)
    windows = -(-lags // m)
    ops, b, sup, modes = bs._os_operands(
        ns, hs, torch.from_numpy(plan["centers"]).to(DEVICE),
        torch.from_numpy(plan["rel"]).to(DEVICE), FS, m, plan["block_len"],
        windows, lags)
    p_eff = ns.shape[0] * plan["bands"] * windows
    return ops, b, sup, m, modes, (
        f"Kb={plan['kb']} P={ns.shape[0]} S={plan['bands']} W={windows} "
        f"P_eff={p_eff} M={m} D={plan['block_len']}")


def phase_kernel_modes(cfg3):
    """K1 in modes (c), (d) and (c+d) at config 3's full shape."""
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    ops, b, sup, m, modes, shape = config_operands(cfg3)
    ws1, ws2, lmat, h_ext = ops
    s, w, nv = modes["share_h"], modes["windows"], modes["num_valid"]
    print(f"[modes] config 3 operands: {shape}; window lag bounds "
          f"{nv[:w].tolist()}")
    fs.LAUNCHES = 0
    compare(f"K1 (c) share_h={s}, config 3", (ws1, ws2, lmat, h_ext[:1]),
            b, sup, m, share_h=s)
    # (d) with the last window cut to half its lags, so the bound masks
    # inside the kernel's per-bin max.
    cut = nv[:w].clone()
    cut[-1] //= 2
    compare(f"K1 (d) windows={w} + num_valid {cut[-1].item()} in the last "
            f"window, config 3", (ws1, ws2, lmat[:1], h_ext), b, sup, m,
            windows=w, num_valid=cut)
    err = compare(f"K1 (c+d) share_h={s} x windows={w}, config 3", ops, b,
                  sup, m, **modes)
    print(f"[modes] K1 launches in this phase: {fs.LAUNCHES}")
    check(fs.LAUNCHES == 3, "K1 modes phase did not launch the kernel")
    return err


def run_config(name, cfg):
    """One config through its public engine on the card, gated; returns
    (launches, answers)."""
    from caf_cookoff_tpu_torch import (batched_stein_os_peak,
                                       batched_stein_peak, stein_caf_peak)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    needles, hays, freqs, lags, truths = cfg
    fs.LAUNCHES = 0
    fs.PIPELINED_LAUNCHES = 0
    reset_rescore()
    t0 = time.perf_counter()
    if lags is None:
        fr, lg, vv = batched_stein_peak(needles, hays, freqs, FS,
                                        device=DEVICE)
    else:
        fr, lg, vv = batched_stein_os_peak(needles, hays, freqs, FS,
                                           num_lags=lags, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = fs.LAUNCHES
    pipelined = fs.PIPELINED_LAUNCHES
    rescore_calls(name, 1)
    got = [(float(f), int(l)) for f, l in zip(fr, lg)]
    print(f"[configs] {name}: {len(got)} pairs in {seconds:.2f} s (first "
          f"call), K1 launches {launches} ({pipelined} pipelined); values "
          f"finite and > 0: "
          f"{bool(np.all(np.isfinite(vv)) and np.all(vv > 0))}")
    check(launches > 0, f"{name} did not launch K1")
    # Configs 2-4 give K1 2B = 128 at D = 64 or 64 at D = 128: the
    # pipelined launch's shapes.
    check(pipelined == launches, f"{name}: K1 left the pipelined launch")
    check(bool(np.all(np.isfinite(vv)) and np.all(vv > 0)),
          f"{name} values")
    if truths is None:
        for i in range(0, len(got), 13):
            want = stein_caf_peak(needles[i], hays[i], freqs, FS,
                                  device=DEVICE)[:2]
            print(f"[configs] {name} pair {i}: batch {got[i]}, "
                  f"stein_caf_peak {want}")
            check(got[i] == want, f"{name} pair {i} off its single-pair "
                                  f"answer")
    else:
        misses = [(i, g, t) for i, (g, t) in enumerate(zip(got, truths))
                  if g != t]
        print(f"[configs] {name}: {len(truths) - len(misses)}/"
              f"{len(truths)} injected (freq, lag) recovered; first "
              f"{got[0]} (want {truths[0]})")
        check(not misses, f"{name} missed emitters {misses}")
    return launches


def same_packed_bits(a, b) -> bool:
    """Two packed (3, ...) f64 answers with the same bits: values,
    frequency bins and lags."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


def phase_graph(inputs, cfgs, card):
    """[graph]: the compiled calls (``ops/_graph``, one CUDA graph per
    static key) against their eager cores, bit for bit, over the
    goldens, config1, wide1000, a banded +-3000 Hz grid, config2 and
    its banded batch; the eager cores under sync-debug "error"; a second
    grid of one key replaying; syncs and copies a call; capture ms and
    pool memory a key; a replay's device time by the profiler against
    CUDA events."""
    import torch

    from caf_cookoff_tpu_torch import FreqGrid
    from caf_cookoff_tpu_torch.models.batched_stein import _batched_call
    from caf_cookoff_tpu_torch.models.stein import _stein_call
    from caf_cookoff_tpu_torch.ops import _graph
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)

    def stein(n, h, f):
        return _stein_call(n, h, f, FS, 64, True, None, DEVICE)

    wide = FreqGrid(-1000.0, 1000.0, 5.0).frequencies(np.float32)
    band = FreqGrid(-3000.0, 3000.0, 25.0).frequencies(np.float32)
    cases = [(f"chirp_{idx}", stein(on(n), on(h), f))
             for (idx, *_), (n, h, f, _, _) in zip(GOLDEN, inputs)]
    n1, h1, f1 = bc.build_config1()
    n1, h1 = on(n1), on(h1)
    needles, hays, f2, _, _ = cfgs["config2"]
    ns, hs = on(needles), on(hays)
    cases += [("config1", stein(n1, h1, f1)),
              ("wide1000", stein(n1, h1, wide)),
              ("chirp_0 banded +-3000 Hz", stein(n1, h1, band)),
              ("config2", _batched_call(ns, hs, f2, FS, 64, True, DEVICE)),
              ("config2 banded +-3000 Hz",
               _batched_call(ns, hs, band, FS, 64, True, DEVICE))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = [core(*traced, *static)
                 for _, (core, traced, static, *_) in cases]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[graph] {len(cases)} eager cores raised nothing under "
          f"set_sync_debug_mode('error')")
    c1 = dict(cases)["config1"]
    for (label, (core, traced, static, grid, _)), want in zip(cases, eager):
        captures = _graph.CAPTURES
        t0 = time.perf_counter()
        first = _graph.compiled(core, traced, static)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        captured = _graph.CAPTURES - captures
        got = _graph.compiled(core, traced, static)
        check(_graph.CAPTURES == captures + captured,
              f"[graph] {label}: a second call captured again")
        same = same_packed_bits(first, want) and same_packed_bits(got, want)
        flat = got.reshape(3, -1)
        print(f"[graph] {label}: {core.__name__} static {static}: "
              f"{'captured' if captured else 'replayed'} at its first call "
              f"here ({first_ms:.1f} ms), replay = eager bit for bit: {same};"
              f" first answer {float(grid[int(flat[1, 0])]):+.3f} Hz, lag "
              f"{int(flat[2, 0])}")
        check(same, f"[graph] {label}: the compiled call differs from its "
                    f"eager core")
    # A new grid of config1's shape: the same key, no capture, the eager
    # answer for that grid.
    call = stein(n1, h1, f1 + np.float32(0.125))
    captures = _graph.CAPTURES
    got = _graph.compiled(*call[:3])
    same = same_packed_bits(got, call[0](*call[1], *call[2]))
    print(f"[graph] config1's grid + 0.125 Hz: captures "
          f"{_graph.CAPTURES - captures}, replay = eager: {same}")
    check(same and _graph.CAPTURES == captures,
          "[graph] a second grid of one key did not replay its graph")
    # Syncs and host<->card copies a call: the public calls (replays,
    # the answer read back), and the eager core with its read.
    from caf_cookoff_tpu_torch import batched_stein_peak, caf_peak

    per_call = {}
    for label, fn in (
            ("config1 caf_peak(stein)",
             lambda: caf_peak(n1, h1, f1, FS, backend="stein",
                              device=DEVICE)),
            ("wide1000 caf_peak(stein)",
             lambda: caf_peak(n1, h1, wide, FS, backend="stein",
                              device=DEVICE)),
            ("config2 batched_stein_peak",
             lambda: batched_stein_peak(ns, hs, f2, FS, device=DEVICE)),
            ("config1 eager core + read",
             lambda: c1[0](*c1[1], *c1[2]).cpu())):
        fn()
        dev_ms, ops_, syncs, copies = bc._device_work(fn, 3)
        per_call[label] = (syncs, copies)
        print(f"[graph] {label}: {syncs:g} syncs, {copies:g} host<->card "
              f"copies, {ops_:g} device operations, device {dev_ms:.4f} "
              f"ms a call  [{card}]")
    check(all(s == 1 for s, _ in per_call.values()),
          f"[graph] a call waited on the card more than once: {per_call}")
    # Each step alone: the eager core (no syncs inside) and the compiled
    # call, each with the answer read back, in turns.
    for label in ("config1", "wide1000", "config2"):
        core, traced, static = dict(cases)[label][:3]
        eager_ms, graph_ms_ = [], []
        for _ in range(2):
            eager_ms.append(cuda_median_ms(
                lambda: core(*traced, *static).cpu(), 20, 3))
            graph_ms_.append(cuda_median_ms(
                lambda: _graph.compiled(core, traced, static).cpu(), 20, 3))
        print(f"[graph] {label} whole core + read, medians of 20 in turns: "
              f"eager {eager_ms[0]:.4f} / {eager_ms[1]:.4f} ms, compiled "
              f"{graph_ms_[0]:.4f} / {graph_ms_[1]:.4f} ms  [{card}]")
    for key, ms, pool in _graph.entries():
        print(f"[graph] key {key[0].__name__} {[s for s, _ in key[2]]} "
              f"{key[3]}: capture {ms:.1f} ms, pool "
              f"{pool / 2 ** 20:.1f} MiB  [{card}]")
    # The profiler sees the kernels a graph replays: its device time of
    # config1's replay against CUDA events around the replay alone.
    entry = _graph._CACHES[n1.device].get(_graph.static_key(*c1[:3]))
    replay_ms = cuda_median_ms(entry.graph.replay, 20, 3)
    prof_ms, prof_ops, _, _ = bc._device_work(entry.graph.replay, 5)
    print(f"[graph] config1 graph replay alone: {replay_ms:.4f} ms (CUDA "
          f"events), profiler {prof_ms:.4f} ms device time in {prof_ops:g} "
          f"operations  [{card}]")
    check(0.25 * replay_ms <= prof_ms <= 1.05 * replay_ms,
          "[graph] torch.profiler does not see a replay's kernels")


def outputs_bits(out):
    """A compiled call's outputs as (dtype, shape, bytes) triples."""
    import torch

    out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    return [(t.dtype, tuple(t.shape),
             (torch.view_as_real(t.resolve_conj()) if t.is_complex()
              else t)
             .contiguous().view(-1).view(torch.uint8).cpu())
            for t in out]


def same_outputs(a, b) -> bool:
    import torch

    a, b = outputs_bits(a), outputs_bits(b)
    return len(a) == len(b) and all(
        x[:2] == y[:2] and torch.equal(x[2], y[2]) for x, y in zip(a, b))


def phase_graph_streams(cfgs, card):
    """[graph], the streams and the windowed engines: every compiled call
    of stream3's three streams, stream1000's and configs 3 and 4 (banded
    and one band) against its eager core bit for bit, the eager core
    under sync-debug "error"; a second stream of the same shapes
    captures nothing; syncs a run, a chunk and a call; each new key's
    capture ms and pool memory."""
    import torch

    from caf_cookoff_tpu_torch import StreamingCAF, batched_stein_os_peak
    from caf_cookoff_tpu_torch.models.batched_stein import _os_call
    from caf_cookoff_tpu_torch.ops import _graph
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    needle, hay, two, freqs3, _, _ = bc.build_stream3()
    n, h, h2 = (torch.from_numpy(x).to(DEVICE) for x in (needle, hay, two))
    f1000 = np.linspace(-1000, 1000, 2000, endpoint=False).astype(
        np.float32)
    streams = [("stream3 Stein", h, freqs3, {"backend": "stein"}),
               ("stream3 cuFFT", h, freqs3, {}),
               ("stream3 Stein lattice", h2, freqs3,
                {"backend": "stein", "num_peaks": 3}),
               ("stream1000 Stein", h, f1000, {"backend": "stein"})]

    def run(capture, freqs, kw, needle_t=n):
        s = StreamingCAF(needle_t, freqs, FS, chunk_len=STREAM_CHUNK,
                         device=DEVICE, **kw)
        for i in range(0, capture.shape[-1], STREAM_CHUNK):
            s.process(capture[i:i + STREAM_CHUNK])
        return s.peaks() if s._num_peaks > 1 else s.best()

    compiled, log = _graph.compiled, []

    def eager_checked(core, traced, static=(), occupant=None):
        # A stream's call moves its inputs on (the resident path): keep
        # them as it reads them, and read its carried outputs from them.
        inputs = (traced if occupant is None
                  else tuple(t.clone() for t in traced))
        out = compiled(core, traced, static, occupant=occupant)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = core(*inputs, *static)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        full = out
        if occupant is not None:
            carried, rest = dict(occupant.carried), iter(out)
            full = tuple(occupant.inputs[carried[j]] if j in carried
                         else next(rest)
                         for j in range(len(out) + len(carried)))
        log.append((core.__name__, same_outputs(full, eager)))
        return out

    narrow = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    windowed = []
    for name in ("config3", "config4"):
        ns, hs, freqs, lags, _ = cfgs[name]
        ns, hs = torch.from_numpy(ns).to(DEVICE), torch.from_numpy(hs).to(
            DEVICE)
        windowed += [(f"{name} {label}", ns, hs, g, lags)
                     for label, g in (("banded", freqs),
                                      ("+-100 Hz one band", narrow))]
    _graph.compiled = eager_checked
    try:
        for label, capture, freqs, kw in streams:
            log.clear()
            captures = _graph.CAPTURES
            answer = run(capture, freqs, kw)
            captured = _graph.CAPTURES - captures
            steps = [name for name, _ in log if "step" in name]
            same = all(ok for _, ok in log)
            print(f"[graph] {label}: {len(steps)} steps ({steps[:1]}), "
                  f"{len(log) - len(steps)} other compiled calls "
                  f"({sorted({nm for nm, _ in log} - set(steps))}), "
                  f"{captured} captured; every call = its eager core bit "
                  f"for bit: {same}; answer {answer}")
            check(same and len(steps) == 9,
                  f"[graph] {label}: a compiled call differs from its "
                  f"eager core")
            captures = _graph.CAPTURES
            run(capture * 2.0, freqs + np.float32(0.25), kw, n * 0.5)
            print(f"[graph] {label}, a second stream of the same shapes "
                  f"(other values): captures {_graph.CAPTURES - captures}")
            check(_graph.CAPTURES == captures and all(ok for _, ok in log),
                  f"[graph] {label}: a second stream captured or differed")
        for label, ns, hs, g, lags in windowed:
            log.clear()
            core = _os_call(ns, hs, g, FS, lags, 64, DEVICE)[0]
            first = batched_stein_os_peak(ns, hs, g, FS, num_lags=lags,
                                          device=DEVICE)
            again = batched_stein_os_peak(ns, hs, g, FS, num_lags=lags,
                                          device=DEVICE)
            same = len(log) == 2 and all(ok for _, ok in log)
            print(f"[graph] {label}: {core.__name__}, first call and "
                  f"replay = eager bit for bit: {same}; first pair "
                  f"({float(first[0][0]):+.3f} Hz, {int(first[1][0])})")
            check(same and all(np.array_equal(a, b)
                               for a, b in zip(first, again)),
                  f"[graph] {label}: the compiled call differs from its "
                  f"eager core")
    finally:
        _graph.compiled = compiled
    print(f"[graph] the streams' and windowed engines' eager cores raised "
          f"nothing under set_sync_debug_mode('error')")
    # Syncs: a whole run as the benchmark times it, and a chunk each.
    runs = {}
    for label, capture, freqs, kw in streams:
        fn = (lambda c=capture, f=freqs, k=kw: run(c, f, k))
        dev_ms, ops_, syncs, copies = bc._device_work(fn, 1)
        s = StreamingCAF(n, freqs, FS, chunk_len=STREAM_CHUNK,
                         device=DEVICE, **kw)
        chunks = iter([capture[i:i + STREAM_CHUNK]
                       for i in range(0, capture.shape[-1], STREAM_CHUNK)])
        c_ms, c_ops, c_syncs, c_copies = bc._device_work(
            lambda: s.process(next(chunks)), 9)
        runs[label] = (syncs, c_syncs)
        print(f"[graph] {label} whole run (build, 9 chunks, best/peaks): "
              f"{syncs:g} syncs, {copies:g} host<->card copies, {ops_:g} "
              f"device operations, device {dev_ms:.4f} ms; a chunk: "
              f"{c_syncs:g} syncs, {c_ops:g} device operations, device "
              f"{c_ms:.4f} ms  [{card}]")
    for label, ns, hs, g, lags in windowed:
        fn = (lambda a=ns, b=hs, c=g, d=lags: batched_stein_os_peak(
            a, b, c, FS, num_lags=d, device=DEVICE))
        dev_ms, ops_, syncs, copies = bc._device_work(fn, 3)
        runs[label] = (syncs, syncs)
        print(f"[graph] {label} batched_stein_os_peak: {syncs:g} syncs, "
              f"{copies:g} host<->card copies, {ops_:g} device operations, "
              f"device {dev_ms:.4f} ms a call  [{card}]")
    check(all(run_ <= 12 and one == 1 for run_, one in runs.values()),
          f"[graph] syncs a run / a chunk or call: {runs}")
    # Where a run's host time goes: the build (the needle's read among
    # it), each chunk (its read waits for its replay), best() / peaks().
    for label, capture, freqs, kw in streams:
        parts = {"build": [], "chunk": [], "best": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = StreamingCAF(n, freqs, FS, chunk_len=STREAM_CHUNK,
                             device=DEVICE, **kw)
            torch.cuda.synchronize()
            parts["build"].append((time.perf_counter() - t0) * 1e3)
            for i in range(0, capture.shape[-1], STREAM_CHUNK):
                t0 = time.perf_counter()
                s.process(capture[i:i + STREAM_CHUNK])
                parts["chunk"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            s.peaks() if s._num_peaks > 1 else s.best()
            parts["best"].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in parts.items()}
        print(f"[graph] {label} host clock, medians of 3 runs: build "
              f"{med['build']:.4f} ms, a chunk {med['chunk']:.4f} ms "
              f"(9 a run), best/peaks {med['best']:.4f} ms  [{card}]")
    new = {"_stream_step", "_stream_lattice_step", "_stein_stream_step",
           "_stein_stream_lattice_step", "_stein_lattice_rescore",
           "needle_spectra_conj", "_os_core", "_banded_os_core"}
    kept = _graph.entries()
    for key, ms, pool in kept:
        if key[0].__name__ in new:
            print(f"[graph] key {key[0].__name__} "
                  f"{[sh for sh, _ in key[2]][:6]} {key[3]}: capture "
                  f"{ms:.1f} ms, pool {pool / 2 ** 20:.1f} MiB  [{card}]")
    print(f"[graph] {len(kept)} keys kept (bound {_graph.MAX_GRAPHS})")


def cuda_median_ms(fn, runs: int, warmup: int = 10) -> float:
    """Median of ``runs`` calls of ``fn``, each between two CUDA events;
    a call that waits on the host (``caf_peak`` reads its answer) counts
    its host time too."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def graph_ms(fn, burst: int = 10, rounds: int = 20) -> float:
    """Device ms of one call of ``fn``: CUDA-event medians of replays of
    a CUDA graph of ``burst`` calls, so no host time sits between the
    launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()                             # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(burst):
            fn()
    return cuda_median_ms(graph.replay, rounds, 3) / burst


def device_ms(fn, runs: int = 20) -> float:
    """Device time a call of ``fn``: the kernels' and memsets' time in a
    ``torch.profiler`` trace of ``runs`` calls (after warm-up), over
    ``runs``; the host's launch time is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    check(us > 0, "torch.profiler saw no device time")
    return us / 1e3 / runs


def device_work(fn, runs: int = 10):
    """(device ms, device operations) a call of ``fn``: the kernels,
    memsets and copies in a ``torch.profiler`` trace of ``runs`` calls
    after warm-up, summed and counted, over ``runs``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in ops)
    check(us > 0, "torch.profiler saw no device time")
    return us / 1e3 / runs, len(ops) / runs


def recompute_tiles(lag1, sep, m):
    """K1(e)'s recomputed 128-lag tiles in this run (a diagnostic: work
    the kernel repeats, not work the rank needs): per (bin, program), the
    tiles that straddle an edge of [lag1 - sep, lag1 + sep] (at most two,
    one when both edges fall in one tile)."""
    m_pad = -(-m // 128) * 128
    lo, hi = lag1.long() - sep, lag1.long() + sep
    t_lo = (lo >= 1) & (lo % 128 != 0)
    t_hi = (hi + 1 < m_pad) & ((hi + 1) % 128 != 0)
    same = t_lo & t_hi & (lo // 128 == hi // 128)
    return int((t_lo.sum() + t_hi.sum() - same.sum()).item())


def stein_bound_ms(ops, m, modes=None, top2=False):
    """K1: per lag each program needs stage A's G column, 2*(2B)*(2D)
    FLOP, and stage B's two syntheses, 2*2*K*2B FLOP, on bf16-exact
    operands at the bf16 tensor-core peak, over the lags it must rank
    (``m``, or ``num_valid`` when smaller); against its operands read and
    (K, P_eff) outputs written once at the HBM rate.  ``top2``: mode (e)
    needs the same operations (its second slot is a reduction) and
    writes a second pair of outputs.  Returns (ms, what bounds it,
    GFLOP)."""
    import torch

    ws1, _, lmat, _ = ops
    modes = modes or {}
    _, b2, d2 = lmat.shape
    p = lmat.shape[0] * modes.get("windows", 1)
    k = ws1.shape[0]
    nv = modes.get("num_valid")
    lags = (p * m if nv is None
            else int(torch.clamp(nv, max=m).sum().item()))
    flops = lags * (2.0 * b2 * d2 + 2.0 * 2 * k * b2)
    outs = 2 if top2 else 1
    nbytes = (sum(t.numel() * 4 for t in ops) + k * p * 8 * outs
              + (0 if nv is None else nv.numel() * 4))
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def stage_b_matmul_ms(ops, m, modes=None):
    """K1's library yardstick at one shape: stage B's product alone as
    one bf16 ``torch.matmul``, [ws1; ws2] (2K, 2B) @ G (P_eff, 2B,
    m_pad) on a random G (the port never calls it)."""
    import torch

    ws1, ws2, lmat, _ = ops
    p = lmat.shape[0] * (modes or {}).get("windows", 1)
    ws = torch.cat([ws1, ws2]).to(torch.bfloat16)
    g = torch.randn(p, lmat.shape[1], -(-m // 128) * 128, device=DEVICE
                    ).to(torch.bfloat16)
    ms = cuda_median_ms(lambda: torch.matmul(ws, g), 10, 3)
    del g
    torch.cuda.empty_cache()
    return ms


def k4_bound_ms():
    """K4: the (416, 8192) f32 pair swept 64 times, 6 operations an
    element and sweep (2 offset adds, |R|^2's 2 mul and 1 add, 1 max),
    none an fma, at the card's rate for non-fma f32 operations (half
    its 67 TFLOP/s, which counts an fma as two), against its
    (416,) output written once at the HBM rate (nothing is read).
    Returns (ms, what bounds it, GOP)."""
    from caf_cookoff_tpu_torch.utils import roofline as rf

    ops = rf.KP * rf.M * rf.REPEAT * float(rf.OPS_PER_ELEM)
    t_ops, t_bytes = ops / (F32_FLOPS / 2), rf.KP * 4 / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"), ops / 1e9


def filterbank_bound_ms(k, n, m, surface: bool):
    """K2/K3: per bin the shifted needle (sincos ~8 + 6 FLOP a sample),
    two 5*M*log2(M) f32 FFTs, the product (6M) and |.|^2 (3M; K3 scales,
    +M), plus H's transform, at the f32 peak; against needle, haystack
    and grid read once and the outputs written once at the HBM rate."""
    flops = (k * (14.0 * n + 2 * 5.0 * m * math.log2(m) + 9.0 * m
                  + (m if surface else 0)) + 5.0 * m * math.log2(m))
    nbytes = 16.0 * n + 4 * k + (4.0 * k * m if surface else 8.0 * k)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")


def filterbank_occupancy(k, m, surface: bool):
    """K2's or K3's launch at (k, m): blocks a SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the wrapper's
    cluster size, clusters the card holds at once, waves of the grid."""
    import ctypes

    import torch

    from caf_cookoff_tpu_torch.ops import _build
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    c = pc.cluster_size(m)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.load_library().caf_filterbank_occupancy(
        int(surface), m, c, ctypes.byref(blocks), ctypes.byref(clusters))
    check(rc == 0 and blocks.value > 0, "filterbank occupancy query")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = blocks.value * sms
    return {"blocks_per_sm": blocks.value, "cluster": c,
            "max_active_clusters": clusters.value, "blocks": k * c,
            "waves": math.ceil(k * c / slots),
            "last_wave_fill": round(((k * c - 1) % slots + 1) / slots, 4)}


def phase_times(head, fb_head, inputs, card):
    import torch

    from caf_cookoff_tpu_torch import BENCH_GRID, caf_peak
    from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2
    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    ops, b, sup, m = head
    n0, h0 = inputs[0][0], inputs[0][1]
    bench = BENCH_GRID.frequencies(np.float32)
    shape = "K=400 M=8192 D=64 P=1"
    t = {}
    t["k1"] = cuda_median_ms(
        lambda: fs.fused_stein_rank(*ops, b, sup, m, want_idxs=False), 100)
    before = fs.PIPELINED_LAUNCHES
    t["k1_device"] = device_ms(
        lambda: fs.fused_stein_rank(*ops, b, sup, m, want_idxs=False))
    launch = "pipelined" if fs.PIPELINED_LAUNCHES > before else "tile"
    t["k1_plain"] = cuda_median_ms(
        lambda: surface_plain(ops, b, sup, m).max(dim=-1), 20)
    # Stage B's product alone, [ws1; ws2] (2K, 2B) @ G (2B, m_pad), bf16.
    ws = torch.cat([ops[0], ops[1]]).to(torch.bfloat16)
    g = torch.randn(ops[2].shape[1], -(-m // 128) * 128, device=DEVICE
                    ).to(torch.bfloat16)
    t["k1_matmul"] = cuda_median_ms(lambda: torch.matmul(ws, g), 100)
    t["stein_main"] = cuda_median_ms(
        lambda: caf_peak(n0, h0, bench, FS, backend="stein", device=DEVICE),
        50)
    needle, hay, freqs, mf = fb_head
    t["k2"] = cuda_median_ms(
        lambda: pc.pallas_peak_rows(needle, hay, freqs, FS, mf), 100)
    t["k2_plain"] = cuda_median_ms(
        lambda: pc.caf_peak_rows_plain(needle, hay, freqs, FS, mf), 50)
    t["k2_library"] = cuda_median_ms(
        lambda: mag2(_surface_rows(needle, hay, freqs, FS, mf)).max(dim=-1),
        50)
    # The launches alone on prepared operands: ten back to back from
    # Python (CUDA events around the ten, the script's measure from its
    # first version), and device time (replays of a CUDA graph of ten, no
    # host between them).
    kops = pc._kernel_operands(needle, hay, freqs, FS, mf)
    # The refine tier's second launch: the 8 bins nearest chirp_0's peak.
    near = torch.argsort((freqs - 69.25).abs())[:8].sort().values
    kops8 = pc._kernel_operands(needle, hay, freqs[near], FS, mf)

    def alone(which, ops_):
        return cuda_median_ms(
            lambda: [pc._run_kernel(which, *ops_, mf) for _ in range(10)],
            20) / 10

    def device(which, ops_):
        return graph_ms(lambda: pc._run_kernel(which, *ops_, mf))

    t["k2_alone"], t["k2_device"] = alone("peak", kops), device("peak", kops)
    t["k3_alone"], t["k3_device"] = (alone("surface", kops),
                                     device("surface", kops))
    t["k2_alone_k8"], t["k2_device_k8"] = (alone("peak", kops8),
                                           device("peak", kops8))
    # K2 at one full wave (blocks a SM x SMs bins, 396 on a 132-SM card):
    # what the 400-bin launch's part-filled second wave costs.
    occ = filterbank_occupancy(freqs.shape[0], mf, surface=False)
    k_wave = occ["blocks_per_sm"] * torch.cuda.get_device_properties(
        0).multi_processor_count // occ["cluster"]
    t["k_wave"] = k_wave
    t["k2_device_wave"] = None
    if k_wave < freqs.shape[0]:
        kops_w = kops._replace(rates=kops.rates[:k_wave])
        t["k2_device_wave"] = graph_ms(
            lambda: pc._run_kernel("peak", *kops_w, mf))
    t["k3"] = cuda_median_ms(
        lambda: pc.pallas_surface(needle, hay, freqs, FS, mf), 100)
    t["k3_plain"] = cuda_median_ms(
        lambda: pc.caf_surface_plain(needle, hay, freqs, FS, mf), 50)
    t["k3_library"] = cuda_median_ms(
        lambda: mag2(_surface_rows(needle, hay, freqs, FS, mf)), 50)
    t["refine_main"] = cuda_median_ms(
        lambda: caf_peak(n0, h0, bench, FS, backend="pallas-refine",
                         device=DEVICE), 50)
    fb = "400x8192"
    for what, ms in (
            (f"K1 fused_stein_rank wrapper (rounding, tile and decode "
             f"launches), {shape}", t["k1"]),
            (f"K1 device time a call ({launch} launch; torch.profiler, its "
             f"launches and memset), {shape}", t["k1_device"]),
            (f"K1 plain version (surface with the kernel's roundings and "
             f"sums + max), {shape}", t["k1_plain"]),
            (f"K1 reference: stage B's product alone, bf16 torch.matmul "
             f"(800x128 @ 128x8192)", t["k1_matmul"]),
            ("caf_peak stein main path, 400x8192, per surface incl. host",
             t["stein_main"]),
            (f"K2 pallas_peak_rows wrapper (H by cuFFT + gather + 1 "
             f"launch), {fb}",
             t["k2"]),
            (f"K2 launch alone (prepared operands, 10 back to back from "
             f"Python), {fb}", t["k2_alone"]),
            (f"K2 launch, device time (prepared operands, a CUDA graph of "
             f"10), {fb}", t["k2_device"]),
            (f"K2 launch, device time at one full wave, K={k_wave} M={mf}",
             t["k2_device_wave"] if t["k2_device_wave"] is not None
             else float("nan")),
            (f"K2 caf_peak_rows_plain (torch.fft), {fb}", t["k2_plain"]),
            (f"K2 library: cuFFT filterbank rows + |.|^2 + per-bin max "
             f"(several PyTorch calls), {fb}", t["k2_library"]),
            (f"K2 launch alone at the refine tier's K=8 (C={kops8.c}, 10 "
             f"back to back from Python), M=8192", t["k2_alone_k8"]),
            (f"K2 launch at the refine tier's K=8, device time, M=8192",
             t["k2_device_k8"]),
            (f"K3 pallas_surface wrapper (H by cuFFT + gather + 1 "
             f"launch), {fb}",
             t["k3"]),
            (f"K3 launch alone (prepared operands, 10 back to back from "
             f"Python), {fb}", t["k3_alone"]),
            (f"K3 launch, device time (prepared operands, a CUDA graph of "
             f"10), {fb}", t["k3_device"]),
            (f"K3 caf_surface_plain (torch.fft), {fb}", t["k3_plain"]),
            (f"K3 library: cuFFT filterbank rows + |.|^2 (several PyTorch "
             f"calls), {fb}", t["k3_library"]),
            ("caf_peak pallas-refine, 400x8192, per surface incl. host",
             t["refine_main"])):
        print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    return t


def phase_config_times(cfgs, launches, card):
    """Per config: K1 held against its plain version at the shape its
    engine gives it (as in ``compare``), their times, K1's bound, and
    whole engine calls (host included)."""
    from caf_cookoff_tpu_torch import batched_stein_os_peak, batched_stein_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    rows = {}
    for name, cfg in cfgs.items():
        needles, hays, freqs, lags, _ = cfg
        ops, b, sup, m, modes, shape = config_operands(cfg)
        err = compare(f"K1 at {name}'s shape ({shape})", ops, b, sup, m,
                      **modes)
        bound, by, gflop = stein_bound_ms(ops, m, modes)
        k1 = cuda_median_ms(lambda: fs.fused_stein_rank(
            *ops, b, sup, m, want_idxs=lags is not None, **modes), 10, 3)
        before = fs.PIPELINED_LAUNCHES
        k1_device = device_ms(lambda: fs.fused_stein_rank(
            *ops, b, sup, m, want_idxs=lags is not None, **modes), 10)
        launch = ("pipelined" if fs.PIPELINED_LAUNCHES > before
                  else "tile")
        plain = cuda_median_ms(lambda: surface_plain(
            ops, b, sup, m, **modes).max(dim=-1), 3, 1)
        if lags is None:
            call = cuda_median_ms(lambda: batched_stein_peak(
                needles, hays, freqs, FS, device=DEVICE), 5, 2)
        else:
            call = cuda_median_ms(lambda: batched_stein_os_peak(
                needles, hays, freqs, FS, num_lags=lags, device=DEVICE), 5, 1)
        library = stage_b_matmul_ms(ops, m, modes)
        rows[name] = {"shape": shape, "launches": launches[name],
                      "launch": launch, "device_ms": k1_device,
                      "max_abs_err": err, "ms": k1, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": by, "gflop": gflop,
                      "library_ms": library, "call_ms": call,
                      "pairs": needles.shape[0]}
        for what, ms in ((f"K1 fused_stein_rank wrapper, {name}: {shape}",
                          k1),
                         (f"K1 device time a call ({launch} launch; "
                          f"torch.profiler), {name}", k1_device),
                         (f"K1 plain version (surface with the kernel's "
                          f"roundings and sums + max), {name}", plain),
                         (f"K1 bound ({by}, {gflop:.1f} GFLOP), {name}",
                          bound),
                         (f"K1 library yardstick: stage B alone as one bf16 "
                          f"torch.matmul, {name}", library),
                         (f"{name} whole engine call ({needles.shape[0]} "
                          f"pairs, host included)", call)):
            print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    return rows


def top2_plain(ops, b, sup, m, sep, **modes):
    """K1(e)'s plain version: :func:`surface_plain` ranked by
    ``top2_separated``; four (K, P_eff) fields."""
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    surf = surface_plain(ops, b, sup, m, **modes)
    return [t.T for t in fs.top2_separated(surf, sep)]


def compare_top2(label, ops, b, sup, m, sep, **modes):
    """K1(e) through :func:`bound_check`, both slots.  Returns (the
    kernel's four fields, max abs err)."""
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    got = fs.fused_stein_rank(*ops, b, sup, m, want_top2=True, sep=sep,
                              **modes)
    return got, bound_check(label, got, ops, b, sup, m, sep=sep, **modes)


def spike_operands(spikes, n, d, k, v, needle=None, span_hz=100.0):
    """One program of K1 on a capture of needle copies ``(lag, amp)`` (an
    impulse needle by default: |R|^2 is then the squared amplitude at
    each lag, flat over the bins), linear window slices, ``k`` bins over
    +-``span_hz``."""
    import torch

    from caf_cookoff_tpu_torch.models.batched_stein import (
        _needle_operator, _os_window_extensions)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    if needle is None:
        needle = np.zeros(n, np.complex64)
        needle[0] = 1.0
    hay = np.zeros(v + n, np.complex64)
    for lag, amp in spikes:
        hay[lag:lag + n] += amp * needle
    nt = torch.from_numpy(needle).to(DEVICE)[None]
    ht = torch.from_numpy(hay).to(DEVICE)[None]
    lmat, sup = _needle_operator(nt.real, nt.imag, d)
    h_ext = _os_window_extensions(ht.real, ht.imag, v, 1,
                                  fs.fused_span(n // d, sup, v))
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-span_hz, span_hz, k, device=DEVICE), FS, n // d, d)
    return (ws1, ws2, lmat, h_ext), n // d, sup, v


def lattice_exclusions(cfg):
    from caf_cookoff_tpu_torch.ops.peak import resolution_cell

    needles, _, freqs, _, _ = cfg
    return resolution_cell(needles[0], freqs, FS)


def phase_kernel_top2(lcfgs):
    """K1(e) at both lattice shapes, as their engines build the operands,
    and in the adversarial cases."""
    rng = np.random.default_rng(4)
    errs, shapes = {}, {}
    for name, cfg in lcfgs.items():
        ops, b, sup, m, modes, shape = config_operands(cfg)
        sep = lattice_exclusions(cfg)[1]
        got, errs[name] = compare_top2(f"K1(e) at {name}'s shape ({shape})",
                                       ops, b, sup, m, sep, **modes)
        shapes[name] = (ops, b, sup, m, modes, shape, sep, got[1])
    # A same-bin pair 1.5 sep apart, the stronger 2 past a 512- (and
    # 128-) lag tile edge, its skirt in the previous tile: the TPU
    # kernel's greedy tile merge drops the weaker; this kernel keeps it.
    got, _ = compare_top2("K1(e) pair 1.5 sep across a tile edge",
                          *spike_operands([(514, 3.0), (511, 2.5),
                                           (505, 2.0)], 512, 64, 16, 1024),
                          sep=6)
    lags = (got[1].unique().tolist(), got[3].unique().tolist())
    print(f"[kernel] K1(e) tile-edge pair: slot lags {lags} (want "
          f"([514], [505]))")
    check(lags == ([514], [505]), "K1(e) lost the weaker of the pair")
    # Bit-identical copies at 1310 (in the tile the kernel recomputes, at
    # the window's edge) and 5000 (from stage B) outside the window of a
    # stronger copy at 1000: an exact tie, the lower lag wins.
    needle = (rng.standard_normal(128)
              + 1j * rng.standard_normal(128)).astype(np.complex64)
    got, _ = compare_top2("K1(e) tie across a recomputed tile",
                          *spike_operands([(1000, 2.0), (1310, 1.0),
                                           (5000, 1.0)], 128, 32, 64, 8192,
                                          needle), sep=300)
    lags = (got[1].unique().tolist(), got[3].unique().tolist())
    print(f"[kernel] K1(e) tie: slot lags {lags} (want ([1000], [1310]))")
    check(lags == ([1000], [1310]), "K1(e) tie did not keep the lower lag")
    # At 2B = 128 (a 1024-sample needle, D = 16), where a sum's order
    # shows in its rounding: a copy at 2890, in the tile straddling the
    # lower edge of the window around a stronger copy at 4000 (sep 1100),
    # ties a copy from the tile pass at 1000 or at 7000, in 64 bins over
    # +-10 Hz (within the needle's mainlobe, so every bin peaks at the
    # copies).  A recompute summed otherwise than the tile pass loses one
    # of the two ties.
    needle = (rng.standard_normal(1024)
              + 1j * rng.standard_normal(1024)).astype(np.complex64)
    for partner in (1000, 7000):
        got, _ = compare_top2(
            f"K1(e) tie across a recomputed tile, 2B=128, partner {partner}",
            *spike_operands([(4000, 2.0), (2890, 1.0), (partner, 1.0)], 1024,
                            16, 64, 8192, needle, 10.0), sep=1100)
        lags = (got[1].unique().tolist(), got[3].unique().tolist())
        want = ([4000], [min(2890, partner)])
        print(f"[kernel] K1(e) tie, 2B=128, partner {partner}: slot lags "
              f"{lags} (want {want})")
        check(lags == want, "K1(e) tie did not keep the lower lag")
    # A window bounded to 0 lags, and a sep past every lag.
    ops, b, sup, m, modes, _ = config_operands(lcfgs["lattice4"])
    cut = modes["num_valid"].clone()
    cut[1::4] = 0
    got, _ = compare_top2("K1(e) windows bounded to 0 lags, config 4 shape",
                          ops, b, sup, m, 1, **dict(modes, num_valid=cut))
    zero = [got[i][:, 1::4] for i in range(4)]
    check(all(bool((z == want).all()) for z, want in
              zip(zero, (-1.0, 0, -1.0, 0))),
          "K1(e) zero-lag windows not (-1.0, 0) in both slots")
    got, _ = compare_top2("K1(e) sep past every lag, config 2 shape",
                          *shapes["lattice2"][:4], sep=10 ** 6,
                          **shapes["lattice2"][4])
    check(bool((got[2] == -1.0).all() and (got[3] == 0).all()),
          "K1(e) slot 2 not (-1.0, 0) with sep past every lag")
    return errs, shapes


def lattice_inputs():
    """The two lattice workloads (the port's benchmark's builders):
    lattice2, config 2's shape with two emitters a pair in bins 200
    apart; lattice4, ``docs/bench_multi_emitter.py:65-87``.  Name ->
    (needles, haystacks, freqs, num_lags or None, per-pair [(freq, lag)]
    truths)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    return {"lattice2": bc.build_lattice2(), "lattice4": bc.build_lattice4()}


NUM_PEAKS = {"lattice2": 2, "lattice4": 3}


def run_lattice(name, cfg):
    """One lattice workload through its public engine on the card, gated
    by its truths and held to its oracle on the first and last pairs
    (and any pair found only within a cell of a truth); returns K1's
    launches."""
    from caf_cookoff_tpu_torch import (batched_overlap_save_peaks_local,
                                       batched_stein_os_peaks,
                                       batched_stein_peaks, caf_surface,
                                       find_peaks)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    needles, hays, freqs, lags, truths = cfg
    num = NUM_PEAKS[name]
    fs.LAUNCHES = 0
    reset_rescore()
    t0 = time.perf_counter()
    if lags is None:
        fr, lg, vv = batched_stein_peaks(needles, hays, freqs, FS, num,
                                         device=DEVICE)
    else:
        fr, lg, vv = batched_stein_os_peaks(needles, hays, freqs, FS, num,
                                            num_lags=lags, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = fs.LAUNCHES
    rescore_calls(name, 0)
    rows = [[(float(f), int(l)) for f, l, v in zip(fr[i], lg[i], vv[i])
             if np.isfinite(v)] for i in range(len(needles))]
    ef, el = lattice_exclusions(cfg)
    step = float(freqs[1] - freqs[0])

    def found(truth, pair_rows):
        # Long captures: the recipe's exact (freq, lag).  Equal-length
        # pairs: within one resolution cell, since each emitter's
        # mainlobe there carries the other's cross-ambiguity sidelobe
        # (~1/sqrt(N) of it), which can move the exact surface's
        # maximum by a bin (the oracle below holds the rows exactly).
        if lags is not None:
            return truth in pair_rows
        return any(abs(f - truth[0]) <= ef * step and abs(l - truth[1]) <= el
                   for f, l in pair_rows)

    misses = [(i, r, t) for i, (r, t) in enumerate(zip(rows, truths))
              if not all(found(e, r) for e in t)]
    exact = sum(set(t) <= set(r) for r, t in zip(rows, truths))
    print(f"[lattices] {name}: {len(rows)} pairs x {num} slots in "
          f"{seconds:.2f} s (first call), K1 launches {launches}; pairs "
          f"with every emitter among their rows: {len(rows) - len(misses)}/"
          f"{len(rows)} ({exact} at the exact (freq, lag)); pair 0 "
          f"{rows[0]} (want {truths[0]})")
    check(launches > 0, f"{name} did not launch K1")
    check(not misses, f"{name} missed emitters {misses[:3]}")
    # The oracle holds the first and last pairs, and every pair found
    # only within a cell of a truth.
    oracle_pairs = sorted({0, len(needles) - 1} | {
        i for i, (r, t) in enumerate(zip(rows, truths))
        if not set(t) <= set(r)})
    if lags is None:
        m = 2 * needles.shape[-1]
        want = []
        for i in oracle_pairs:
            surf = caf_surface(needles[i], hays[i], freqs, FS, backend="xla",
                               device=DEVICE)
            pk = find_peaks(surf, num, ef, el, lag_period=m)
            want.append(([(float(freqs[int(f)]), int(l)) for f, l in
                          zip(pk.freq_idx, pk.lag_idx)],
                         pk.value.cpu().numpy()))
        what = "find_peaks on caf_surface(xla)"
    else:
        wf, wl, wv = batched_overlap_save_peaks_local(
            needles[oracle_pairs], hays[oracle_pairs], freqs, FS, num,
            num_lags=lags, exclude_freq=ef, exclude_lag=el, device=DEVICE)
        want = [([(float(f), int(l)) for f, l in zip(wf[j], wl[j])], wv[j])
                for j in range(len(oracle_pairs))]
        what = "batched_overlap_save_peaks_local"
    for i, (w_rows, w_vals) in zip(oracle_pairs, want):
        got_rows = [(float(f), int(l)) for f, l in zip(fr[i], lg[i])]
        # Equal-length lattices hold every row; long captures the
        # emitters' rows (slots past them are sidelobe-level).
        keep = (range(num) if lags is None else
                [j for j, r in enumerate(w_rows) if r in truths[i]])
        rel = max(abs(vv[i][j] - w_vals[j]) / abs(w_vals[j]) for j in keep)
        same = all(got_rows[j] == w_rows[j] for j in keep)
        print(f"[lattices] {name} pair {i} vs {what}: rows {got_rows} / "
              f"{w_rows}, compared rows identical: {same}, max rel value "
              f"err {rel:.3e} (tol 2e-5)")
        check(same and len(keep) >= len(truths[i]),
              f"{name} pair {i} off its oracle")
        check(rel <= 2e-5, f"{name} pair {i} values off its oracle")
    return launches


def phase_lattice_times(lcfgs, shapes, launches, card):
    """Per lattice workload: K1(e)'s wrapper, its plain version and bound,
    the whole lattice call and the cuFFT lattice yardstick per pair."""
    from caf_cookoff_tpu_torch import (batched_overlap_save_peaks_local,
                                       batched_stein_os_peaks,
                                       batched_stein_peaks, caf_surface,
                                       find_peaks)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    rows = {}
    for name, cfg in lcfgs.items():
        needles, hays, freqs, lags, _ = cfg
        ops, b, sup, m, modes, shape, sep, lag1 = shapes[name]
        num = NUM_PEAKS[name]
        ef, el = lattice_exclusions(cfg)
        bound, by, gflop = stein_bound_ms(ops, m, modes, top2=True)
        k1 = cuda_median_ms(lambda: fs.fused_stein_rank(
            *ops, b, sup, m, want_top2=True, sep=sep, **modes), 10, 3)
        plain = cuda_median_ms(lambda: top2_plain(ops, b, sup, m, sep,
                                                  **modes), 3, 1)
        if lags is None:
            call = cuda_median_ms(lambda: batched_stein_peaks(
                needles, hays, freqs, FS, num, device=DEVICE), 5, 2)
            scan = cuda_median_ms(lambda: [find_peaks(caf_surface(
                needles[i], hays[i], freqs, FS, backend="xla",
                device=DEVICE), num, ef, el, lag_period=m).value.cpu()
                for i in (0, 1)], 3, 1) / 2
            yard = "caf_surface(xla) + find_peaks"
        else:
            call = cuda_median_ms(lambda: batched_stein_os_peaks(
                needles, hays, freqs, FS, num, num_lags=lags,
                device=DEVICE), 5, 1)
            scan = cuda_median_ms(lambda: batched_overlap_save_peaks_local(
                needles[:2], hays[:2], freqs, FS, num, num_lags=lags,
                exclude_freq=ef, exclude_lag=el, device=DEVICE), 3, 1) / 2
            yard = "batched_overlap_save_peaks_local"
        pairs = needles.shape[0]
        library = stage_b_matmul_ms(ops, m, modes)
        rows[name] = {"shape": shape, "sep": sep, "launches": launches[name],
                      "ms": k1, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": by, "gflop": gflop, "library_ms": library,
                      "recomputed_tiles": recompute_tiles(lag1, sep, m),
                      "call_ms": call, "pairs": pairs,
                      "cufft_lattice_ms_per_pair": scan}
        for what, ms in (
                (f"K1(e) fused_stein_rank want_top2 wrapper, {name}: "
                 f"{shape} sep={sep}", k1),
                (f"K1(e) plain version (coarse_surface_plain with the "
                 f"kernel's roundings and sums + top2_separated), {name}",
                 plain),
                (f"K1(e) bound ({by}, {gflop:.1f} GFLOP), {name}", bound),
                (f"K1 library yardstick: stage B alone as one bf16 "
                 f"torch.matmul, {name}", library),
                (f"{name} whole lattice call ({pairs} pairs x {num} slots, "
                 f"host included)", call),
                (f"{name} yardstick {yard}, per pair", scan)):
            print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    return rows


def rate_inputs():
    """The rate workloads: rate3 (``docs/bench_rate.py:61-83``: config
    3's shape, 9 trial rates, one emitter at 150 Hz/s), ratelat3 (rate3
    with a second, weaker emitter), both from the port's benchmark's
    builders, and rate1 (``tests/test_rate.py:34-48``: a 412.34 Hz/s
    sweep in a needle-length window).  Name -> (needle, haystack, freqs,
    rates, [(rate, freq, lag)] truths)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    cfg = {}
    for name, (needle, hay, freqs, rates, lags, truths) in (
            bc.build_rate3().items()):
        # The recipe searches ``lags`` lags of its lags + n samples: the
        # last sample reaches no searched lag, so the captures end
        # before it and the engines' default lag count is the recipe's.
        cfg[name] = (needle, hay[:lags + len(needle) - 1], freqs, rates,
                     truths)
    n = 4096
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    t_sec = np.arange(n) / FS
    hay = (1e-4 * (rng.standard_normal(n)
                   + 1j * rng.standard_normal(n))).astype(np.complex64)
    hay[137:] += (needle * np.exp(2j * np.pi * 20.0 * t_sec + 1j * np.pi
                                  * 412.34 * t_sec ** 2)
                  ).astype(np.complex64)[:n - 137]
    cfg["rate1"] = (needle, hay, np.arange(-100, 100, 0.5, dtype=np.float32),
                    np.arange(-600.0, 601.0, 100.0), [(412.34, 20.0, 137)])
    return cfg


def rate_operands(cfg):
    """K1's mode (f) operands at a rate workload's full shape, as
    ``stein_rate_os_peak`` builds them: (ops with all R*Kb rows, b, sup,
    m, modes, shape label)."""
    import torch

    from caf_cookoff_tpu_torch.models import batched_stein as bs
    from caf_cookoff_tpu_torch.models import rate as rt
    from caf_cookoff_tpu_torch.ops.fused_stein import (
        stein_rate_synthesis_weights)

    needle, hay, freqs, rates, _ = cfg
    n = len(needle)
    d, _, centers, rel, _ = rt._rate_routing(FS, freqs, rates, n, 64,
                                             len(hay))
    m = 2 * n
    lags = len(hay) - n + 1
    windows = -(-lags // m)
    rel_t = torch.from_numpy(rel).to(DEVICE)
    ops, b, sup, modes = bs._os_operands(
        torch.from_numpy(needle).to(DEVICE)[None],
        torch.from_numpy(hay).to(DEVICE)[None],
        torch.from_numpy(centers).to(DEVICE), rel_t, FS, m, d, windows, lags)
    ws1, ws2 = stein_rate_synthesis_weights(rel_t, rates, FS, b, d)
    k = ws1.shape[0]
    p_eff = modes["share_h"] * windows
    return (ws1, ws2) + ops[2:], b, sup, m, modes, (
        f"R={len(rates)} x Kb={len(rel)} = {k} rows, S={modes['share_h']} "
        f"W={windows} P_eff={p_eff} M={m} D={d}; {-(-k // 64)} bin passes "
        f"a tile, top-2 partials {p_eff * k * (m // 128) * 8 / 1e6:.1f} MB "
        f"(none without top-2), P_eff*K = {p_eff * k}")


def phase_kernel_rate(rcfgs):
    """K1 mode (f) at rate3's full shape held to its error bound: single
    (c+d+f) and top-2 (c+d+e+f)."""
    from caf_cookoff_tpu_torch.ops.peak import resolution_cell

    cfg = rcfgs["rate3"]
    ops, b, sup, m, modes, shape = rate_operands(cfg)
    sep = resolution_cell(cfg[0], cfg[2], FS)[1]
    print(f"[rate] rate3 K1 (f) operands: {shape}")
    err = compare(f"K1 (c+d+f) at rate3 ({shape.split(';')[0]})", ops, b,
                  sup, m, **modes)
    got, err2 = compare_top2(f"K1 (c+d+e+f) at rate3", ops, b, sup, m, sep,
                             **modes)
    return (ops, b, sup, m, modes, shape, sep, got[1]), max(err, err2)


def run_rate(name, cfg):
    """One rate workload through its public engines on the card, gated;
    returns (K1 launches of the segmented engine, its answer)."""
    from caf_cookoff_tpu_torch import (caf_peak, rate_caf_peak,
                                       rate_overlap_save_peak,
                                       rate_overlap_save_peaks,
                                       refine_peak_rate, stein_rate_os_peak,
                                       stein_rate_os_peaks)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc

    needle, hay, freqs, rates, truths = cfg
    if name == "rate1":
        fs.LAUNCHES = pc.PEAK_LAUNCHES = pc.SURFACE_LAUNCHES = 0
        r_c, f_c, lag_c, v_c = rate_caf_peak(needle, hay, freqs, rates, FS,
                                             device=DEVICE)
        launches = fs.LAUNCHES + pc.PEAK_LAUNCHES + pc.SURFACE_LAUNCHES
        v1 = caf_peak(needle, hay, freqs, FS, backend="xla",
                      device=DEVICE)[2]
        want_r, want_f, want_l = truths[0]
        print(f"[rate] rate1 rate_caf_peak: {r_c:+.1f} Hz/s, {f_c:+.3f} Hz, "
              f"lag {lag_c}, value {v_c:.6g} = {v_c / v1:.3f} x the "
              f"first-order peak (want lag {want_l}, rate within 100 of "
              f"{want_r}, > 1.3 x); kernel launches {launches} (the dechirp "
              f"bank runs on cuFFT, as the JAX package's runs on XLA)")
        check(lag_c == want_l and abs(r_c - want_r) <= 100.0
              and v_c > 1.3 * v1, "rate1 dechirp bank answer")
        return 0, None
    num = 3 if name == "ratelat3" else 1
    fs.LAUNCHES = 0
    reset_rescore()
    t0 = time.perf_counter()
    if num == 1:
        got = stein_rate_os_peak(needle, hay, freqs, rates, FS, device=DEVICE)
    else:
        got = stein_rate_os_peaks(needle, hay, freqs, rates, FS, num,
                                  device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = fs.LAUNCHES
    rescore_calls(name, 0)
    check(launches > 0, f"{name} did not launch K1")
    if num == 1:
        serial = rate_overlap_save_peak(needle, hay, freqs, rates, FS,
                                        device=DEVICE)
        print(f"[rate] {name}: stein_rate_os_peak {got} in {seconds:.2f} s "
              f"(first call), K1 launches {launches}; serial "
              f"rate_overlap_save_peak {serial}; want {truths[0]}")
        check(got[:3] == serial[:3] == truths[0], f"{name} answers")
        f2, r2, t2, _ = refine_peak_rate(
            needle, hay, got[1], got[2], FS, rate0_hz_per_s=got[0],
            max_rate_hz_per_s=float(rates[1] - rates[0]),
            coarse_step_hz=float(freqs[1] - freqs[0]), device=DEVICE)
        print(f"[rate] {name} refine_peak_rate: {f2:+.4f} Hz, {r2:+.4f} "
              f"Hz/s, lag {t2:.4f} (want |r - 150| <= 0.1, |lag - 30000| "
              f"<= 0.1)")
        check(abs(r2 - 150.0) <= 0.1 and abs(t2 - 30_000) <= 0.1,
              f"{name} refine_peak_rate")
        return launches, got

    def rows(out):
        return [(float(r), float(f), int(l))
                for r, f, l, v in zip(*out[:4]) if np.isfinite(v)]

    serial = rows(rate_overlap_save_peaks(needle, hay, freqs, rates, FS, num,
                                          device=DEVICE))
    print(f"[rate] {name}: stein_rate_os_peaks rows {rows(got)} in "
          f"{seconds:.2f} s (first call), K1 launches {launches}; serial "
          f"rate_overlap_save_peaks rows {serial}; want {truths}")
    check(rows(got)[:2] == serial[:2] == truths, f"{name} lattice rows")
    return launches, got


def phase_refine(pairs):
    """The ten goldens through ``refine_peak`` on the card from the
    cuFFT filterbank's 0.5 Hz answer: within 0.01 Hz and 0.1 samples of
    each fixture's injected truth (``tests/test_refine.py:32-41``)."""
    from caf_cookoff_tpu_torch import caf_peak, refine_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

    freqs = np.arange(-100, 100, 0.5, dtype=np.float32)
    worst, inputs = [0.0, 0.0], []
    for n_path, h_path in pairs:
        needle, hay = load_c64(n_path), load_c64(h_path)
        gt = parse_ground_truth(h_path)
        f0, lag0, _ = caf_peak(needle, hay[:len(needle)], freqs, FS,
                               backend="xla", device=DEVICE)
        fs.LAUNCHES = 0
        f_hat, tau, value = refine_peak(needle, hay, f0, lag0, FS,
                                        coarse_step_hz=0.5, device=DEVICE)
        check(fs.LAUNCHES == 0 and value > 0, "refine_peak")
        worst = [max(worst[0], abs(f_hat - gt.freq_hz)),
                 max(worst[1], abs(tau - gt.lag_samples))]
        inputs.append((needle, hay, f0, lag0))
    print(f"[refine] 10 goldens through refine_peak on the card: worst "
          f"|f - truth| {worst[0]:.5f} Hz (<= 0.01), |lag - truth| "
          f"{worst[1]:.5f} samples (<= 0.1); the zooms are f32 matmuls, no "
          f"kernel of the port")
    check(worst[0] <= 0.01 and worst[1] <= 0.1, "refine_peak goldens")
    return inputs


STREAM_CHUNK = 8192     # stream3: 8 full chunks and a 4096-sample one


def stream_inputs():
    """stream3 (the port's benchmark's builder): config 3's capture
    (69632 samples, 2000 bins over +-500 Hz, the emitter at freqs[1234],
    lag 30000) and its two-emitter version (freqs[345], lag 12000,
    amplitude 1.5 added, as ratelat3 adds its second emitter)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    return bc.build_stream3()


def stream_through(capture, needle, freqs, **kw):
    """``StreamingCAF`` over ``capture`` in ``STREAM_CHUNK``-sample
    chunks on the card: (the stream, its chunk answers)."""
    from caf_cookoff_tpu_torch import StreamingCAF

    s = StreamingCAF(needle, freqs, FS, chunk_len=STREAM_CHUNK,
                     device=DEVICE, **kw)
    return s, [s.process(capture[i:i + STREAM_CHUNK])
               for i in range(0, len(capture), STREAM_CHUNK)]


def stream_k1_operands(s, capture, start):
    """The K1 operands of the Stein stream ``s``'s chunk at ``start``
    (its tail, the N - 1 samples before it, and the chunk zero-padded to
    the pinned length): (ops, b, sup, m, num_valid)."""
    import torch

    from caf_cookoff_tpu_torch.models.streaming import stein_window_operand
    from caf_cookoff_tpu_torch.ops.xcor import pad_to

    n = s.needle_len
    tail = torch.from_numpy(capture[max(start - (n - 1), 0):start]).to(DEVICE)
    tail = torch.cat([tail.new_zeros(n - 1 - tail.shape[-1]), tail])
    chunk = torch.from_numpy(capture[start:start + STREAM_CHUNK]).to(DEVICE)
    valid = chunk.shape[-1]
    _, h_ext = stein_window_operand(tail, pad_to(chunk, STREAM_CHUNK),
                                    s._num_blocks, s._group)
    nv = torch.tensor([valid], dtype=torch.int32, device=DEVICE)
    return ((*s._ws, s._lmat, h_ext), s._num_blocks, s._group, STREAM_CHUNK,
            nv)


def phase_stream(sin):
    """stream3 through ``StreamingCAF`` on the card: the Stein stream
    (K1 at P = 1 a chunk, ``num_valid`` on the short last one) equal to
    ``stein_overlap_save_peak`` and the truth; the cuFFT stream, the same
    answer; the two-emitter capture through the Stein stream's lattice
    (K1 (e), 3 slots), both emitters its first two rows and equal to
    ``overlap_save_peaks``.  K1's launch count, set to 0 before each
    Stein path, must be one a chunk.  Then the last chunk's K1 launch
    against its bound, with ``num_valid`` and with top-2, and the CLI
    ``stream`` verb on chirp_0.  Returns (launches, max abs err)."""
    import contextlib
    import io

    from caf_cookoff_tpu_torch import (cli, overlap_save_peaks,
                                       stein_overlap_save_peak)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    needle, hay, two, freqs, truth, truths2 = sin
    chunks = -(-len(hay) // STREAM_CHUNK)
    fs.LAUNCHES = 0
    fs.PIPELINED_LAUNCHES = 0
    reset_rescore()
    t0 = time.perf_counter()
    s, _ = stream_through(hay, needle, freqs, backend="stein")
    best = s.best()
    seconds = time.perf_counter() - t0
    launches = fs.LAUNCHES
    # 2B = 512 at D = 16: two G tiles pass a block's shared memory.
    check(fs.PIPELINED_LAUNCHES == 0,
          "the Stein stream's K1 took the pipelined launch")
    rescore_calls("stream3", 0)
    want = stein_overlap_save_peak(needle, hay, freqs, FS, device=DEVICE)
    print(f"[stream] stream3 Stein stream, {chunks} chunks of "
          f"{STREAM_CHUNK} ({len(hay)} samples): best {best} in "
          f"{seconds:.2f} s (first run), K1 launches {launches}; "
          f"stein_overlap_save_peak {want}; want {truth}")
    check(launches == chunks, "the Stein stream did not launch K1 once a "
                              "chunk")
    check(best[:2] == want[:2] == truth, "stream3 Stein stream answer")
    check(abs(best[2] / want[2] - 1.0) <= 1e-4, "stream3 exact value")
    c, _ = stream_through(hay, needle, freqs)
    cbest = c.best()
    print(f"[stream] stream3 cuFFT stream: best {cbest}")
    check(cbest[:2] == truth and abs(cbest[2] / best[2] - 1.0) <= 1e-4,
          "stream3 cuFFT stream answer")
    fs.LAUNCHES = 0
    reset_rescore()
    lat, _ = stream_through(two, needle, freqs, backend="stein", num_peaks=3)
    fr, lg, vv = lat.peaks()
    lat_launches = fs.LAUNCHES
    rescore_calls("stream3 lattice", 0)
    rows = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
            if np.isfinite(v)]
    ofr, olg, ovv = overlap_save_peaks(needle, two, freqs, FS, 3,
                                       device=DEVICE)
    orows = [(float(f), int(l)) for f, l, v in zip(ofr, olg, ovv)
             if np.isfinite(v)]
    print(f"[stream] stream3 two emitters, Stein stream lattice (3 slots): "
          f"rows {rows}, K1 launches {lat_launches}; overlap_save_peaks "
          f"rows {orows}; want {truths2}")
    check(lat_launches == chunks, "the Stein lattice stream did not launch "
                                  "K1 once a chunk")
    check(rows[:2] == orows[:2] == truths2, "stream3 lattice rows")
    check(bool(np.allclose(vv[:2], ovv[:2], rtol=1e-4)),
          "stream3 lattice values")
    last = (chunks - 1) * STREAM_CHUNK
    ops, b, sup, m, nv = stream_k1_operands(s, hay, last)
    sep = lat._exclude[1]
    err = bound_check(f"K1 stream3 last chunk, num_valid {int(nv[0])}",
                      fs.fused_stein_rank(*ops, b, sup, m, num_valid=nv),
                      ops, b, sup, m, num_valid=nv)
    ops2 = stream_k1_operands(lat, two, last)[0]
    err = max(err, bound_check(
        "K1 (e) stream3 two-emitter last chunk",
        fs.fused_stein_rank(*ops2, b, sup, m, num_valid=nv, want_top2=True,
                            sep=sep), ops2, b, sup, m, sep=sep,
        num_valid=nv))
    n_path, h_path = (str(ROOT / "data" / f) for f in (
        "chirp_0_raw.c64", "chirp_0_T+202samp_F+69.25Hz.c64"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["stream", n_path, h_path, "--freq-step", "0.25",
                       "--chunk", "2048", "--backend", "stein", "--device",
                       DEVICE])
    lines = out.getvalue().splitlines()
    print(f"[stream] CLI stream chirp_0 (stein, 2048-sample chunks): "
          f"{' | '.join(lines)}")
    check(rc == 0 and "Frequency offset: 69.250 Hz" in lines
          and "Time offset: 202 samples (4.2083 ms)" in lines,
          "CLI stream on chirp_0")
    return launches + lat_launches, err


def phase_stream_times(sin, card):
    """stream3's times: K1 at the stream's chunk shape (a full chunk, and
    the short last one's ``num_valid``; its top-2 mode), its plain
    version, bound and library yardstick, one ``process`` call a chunk,
    whole streams (construction, every chunk, the exact re-score) and
    ``stein_overlap_save_peak``'s whole call on the same capture."""
    from caf_cookoff_tpu_torch import stein_overlap_save_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.ops.peak import resolution_cell

    needle, hay, two, freqs, _, _ = sin
    s, _ = stream_through(hay[:STREAM_CHUNK], needle, freqs,
                          backend="stein")
    ops, b, sup, m, nv = stream_k1_operands(s, hay, 0)
    last = stream_k1_operands(
        s, hay, (len(hay) - 1) // STREAM_CHUNK * STREAM_CHUNK)
    sep = resolution_cell(needle, freqs, FS)[1]     # the lattice's sep
    t = {}
    t["k1"] = cuda_median_ms(lambda: fs.fused_stein_rank(
        *ops, b, sup, m, num_valid=nv), 20, 3)
    t["k1_device"] = device_ms(lambda: fs.fused_stein_rank(
        *ops, b, sup, m, num_valid=nv), 10)
    t["k1_last"] = cuda_median_ms(lambda: fs.fused_stein_rank(
        *last[0], b, sup, m, num_valid=last[4]), 20, 3)
    t["k1_top2"] = cuda_median_ms(lambda: fs.fused_stein_rank(
        *ops, b, sup, m, num_valid=nv, want_top2=True, sep=sep), 20, 3)
    t["plain"] = cuda_median_ms(lambda: surface_plain(
        ops, b, sup, m, num_valid=nv).max(dim=-1), 3, 1)
    bound, by, gflop = stein_bound_ms(ops, m, {"num_valid": nv})
    t["library"] = stage_b_matmul_ms(ops, m)
    chunk = hay[:STREAM_CHUNK]
    t["chunk"] = cuda_median_ms(lambda: s.process(chunk), 20, 3)
    c, _ = stream_through(hay[:STREAM_CHUNK], needle, freqs)
    t["chunk_cufft"] = cuda_median_ms(lambda: c.process(chunk), 20, 3)
    lat, _ = stream_through(two[:STREAM_CHUNK], needle, freqs,
                            backend="stein", num_peaks=3)
    chunk2 = two[4 * STREAM_CHUNK:5 * STREAM_CHUNK]
    t["chunk_lattice"] = cuda_median_ms(lambda: lat.process(chunk2), 20, 3)
    # Device time and device operations a chunk: what is left of a
    # process call is host time.
    work = {name: device_work(fn) for name, fn in (
        ("stein", lambda: s.process(chunk)),
        ("cufft", lambda: c.process(chunk)),
        ("lattice", lambda: lat.process(chunk2)))}
    t["whole"] = cuda_median_ms(lambda: stream_through(
        hay, needle, freqs, backend="stein")[0].best(), 5, 1)
    t["whole_cufft"] = cuda_median_ms(lambda: stream_through(
        hay, needle, freqs)[0].best(), 5, 1)
    t["whole_lattice"] = cuda_median_ms(lambda: stream_through(
        two, needle, freqs, backend="stein", num_peaks=3)[0].peaks(), 5, 1)
    t["stein_os"] = cuda_median_ms(lambda: stein_overlap_save_peak(
        needle, hay, freqs, FS, device=DEVICE), 5, 1)
    shape = (f"K={len(freqs)} 2B={ops[2].shape[1]} D={sup} P=1 "
             f"lags={m}")
    chunks = -(-len(hay) // STREAM_CHUNK)
    rate = len(hay) / (t["whole"] / 1e3)
    for what, ms in (
            (f"K1 fused_stein_rank wrapper, a stream3 chunk: {shape}",
             t["k1"]),
            ("K1 device time a call (tile launch; torch.profiler), a "
             "stream3 chunk", t["k1_device"]),
            (f"K1 at the short last chunk (num_valid {int(last[4][0])})",
             t["k1_last"]),
            (f"K1 (e) top-2 at a stream3 chunk, sep={sep}", t["k1_top2"]),
            ("K1 plain version (surface with the kernel's roundings and "
             "sums + max), a stream3 chunk", t["plain"]),
            (f"K1 bound ({by}, {gflop:.1f} GFLOP), a stream3 chunk", bound),
            ("K1 library yardstick: stage B alone as one bf16 torch.matmul,"
             " a stream3 chunk", t["library"]),
            (f"StreamingCAF.process, one {STREAM_CHUNK}-sample chunk, Stein "
             f"(host included)", t["chunk"]),
            (f"StreamingCAF.process, one {STREAM_CHUNK}-sample chunk, cuFFT",
             t["chunk_cufft"]),
            (f"StreamingCAF.process, one {STREAM_CHUNK}-sample chunk, Stein "
             f"lattice (3 slots, K1 (e))", t["chunk_lattice"]),
            (f"stream3 whole Stein stream (build, {chunks} chunks, best())",
             t["whole"]),
            (f"stream3 whole cuFFT stream (build, {chunks} chunks, best())",
             t["whole_cufft"]),
            ("stream3 two emitters, whole Stein lattice stream (3 slots, "
             "peaks())", t["whole_lattice"]),
            ("stein_overlap_save_peak whole call on the stream3 capture",
             t["stein_os"])):
        print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    for name, (ms, ops_) in work.items():
        print(f"[times] stream3 {name} chunk, device time (torch.profiler): "
              f"{ms:.4f} ms in {ops_:.0f} device operations a chunk  "
              f"[{card}]")
    print(f"[times] stream3 Stein stream: {rate:.4g} samples/s of capture "
          f"({len(hay) / FS * 1e3:.1f} ms of capture in {t['whole']:.4f} "
          f"ms)  [{card}]")
    return {"shape": shape, "ms": t["k1"], "device_ms": t["k1_device"],
            "ms_last_chunk": t["k1_last"],
            "top2_ms": t["k1_top2"], "plain_ms": t["plain"],
            "bound_ms": bound, "bound_by": by, "gflop": gflop,
            "library_ms": t["library"], "chunk_ms": t["chunk"],
            "chunk_cufft_ms": t["chunk_cufft"],
            "chunk_lattice_ms": t["chunk_lattice"],
            "chunk_device": {name: {"ms": ms, "operations": ops_}
                             for name, (ms, ops_) in work.items()},
            "whole_ms": t["whole"],
            "whole_cufft_ms": t["whole_cufft"],
            "whole_lattice_ms": t["whole_lattice"],
            "stein_overlap_save_peak_ms": t["stein_os"],
            "samples_per_s": rate}


# [rows]: K1 past one block's shared memory (2B > 864 at D = 8).
WIDE_GRID = (-1000.0, 1000.0, 5.0)    # wide1000: 400 bins, D = 8, 2B = 1024
ROW_SHAPES = (1024, 1536, 1872)       # 2B of the random operands, D = 8


def row_operands(b2, mode, seed):
    """Random K1 operands at 2B = ``b2`` rows, D = 8, for one mode: (a)
    one pair, K = 400, 8192 lags (the [times] shape); (b) two pairs, (c+d)
    2 bands x 2 windows with the last window's lags cut to 1500, (e) two
    pairs, (f) 3 rates x 64 rate-major rows with (c+d), each at 100 bins
    (or 192 rows) and 2048 lags.  Returns (ops, b, sup, m, modes)."""
    import torch

    from caf_cookoff_tpu_torch.models.batched_stein import (
        _needle_operator, _os_window_extensions)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    rng = np.random.default_rng(seed)
    d, n = 8, b2 // 2 * 8
    b = n // d
    m = 8192 if mode == "a" else 2048
    p, s, w = {"b": (2, 1, 1), "e": (2, 1, 1), "c+d": (1, 2, 2),
               "f": (1, 2, 2)}.get(mode, (1, 1, 1))

    def plane(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(DEVICE)

    lmat, sup = _needle_operator(plane((p * s, n)), plane((p * s, n)), d)
    h = plane((p, w * m + n)), plane((p, w * m + n))
    h_ext = _os_window_extensions(*h, m, w, fs.fused_span(b, sup, m))
    if mode == "f":
        rel = torch.linspace(-100.0, 100.0, 64, device=DEVICE)
        ws = fs.stein_rate_synthesis_weights(
            rel, np.array([-200.0, 0.0, 200.0], np.float32), FS, b, d)
    else:
        ws = fs.stein_synthesis_weights(
            torch.linspace(-1000.0, 1000.0, 400 if mode == "a" else 100,
                           device=DEVICE), FS, b, d)
    modes = {}
    if w > 1:
        nv = torch.tensor([m] * (w - 1) + [1500], dtype=torch.int32,
                          device=DEVICE).repeat(p * s)
        modes = {"windows": w, "share_h": s, "num_valid": nv}
    return (*ws, lmat, h_ext), b, sup, m, modes


def phase_rows(pairs, cfg3):
    """K1 past one block's shared memory, G's rows shared over a cluster
    of blocks a lag tile: random operands at 2B = 1024, 1536 and 1872 in
    modes (a), (b), (c+d), (e) and (f), each held to its bound with its
    launch counted as split; ``caf_peak(backend="stein")`` on chirp_0 over
    the +-1000 Hz step-5 grid (wide1000: D = 8, 2B = 1024) equal to
    ``backend="xla"``'s (freq, lag); the +-1000 Hz (step 1) Stein stream
    over config 3's capture, one split K1 launch a chunk, equal to the
    cuFFT stream's answer and the truth.  Returns (launches of the two
    main paths, max abs err, the wide inputs)."""
    from caf_cookoff_tpu_torch import FreqGrid, caf_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    err = 0.0
    for b2 in ROW_SHAPES + (fs.row_ceiling(8),):
        plan = fs.check_kernel_shape(b2, 8)
        occ = fs.kernel_occupancy(b2, 8)
        print(f"[rows] 2B = {b2}, D = 8: {plan.cluster} blocks a lag tile, "
              f"{plan.rows} rows and {plan.smem} B of shared memory a block; "
              f"{occ['blocks_per_sm']} block(s) a SM, "
              f"{occ['max_active_clusters']} clusters at once")
        check(plan.cluster >= 2 and occ["max_active_clusters"] >= 1,
              f"2B = {b2}: no cluster of {plan.cluster} fits the card")
    for b2 in ROW_SHAPES:
        plan = fs.check_kernel_shape(b2, 8)
        for mode in ("a", "b", "c+d", "e", "f"):
            ops, b, sup, m, modes = row_operands(b2, mode, b2)
            sep = 5 if mode == "e" else None
            fs.SPLIT_LAUNCHES = 0
            got = fs.fused_stein_rank(*ops, b, sup, m,
                                      want_top2=sep is not None,
                                      sep=sep or 0, **modes)
            check(fs.SPLIT_LAUNCHES == 1, f"2B = {b2} ({mode}) did not "
                                          f"launch split")
            err = max(err, bound_check(f"K1 ({mode}) 2B={b2} c={plan.cluster}",
                                       got, ops, b, sup, m, sep, **modes))
    needle, hay = load_pair(pairs, 0)
    freqs = FreqGrid(*WIDE_GRID).frequencies(np.float32)
    fs.LAUNCHES = fs.SPLIT_LAUNCHES = 0
    reset_rescore()
    got = caf_peak(needle, hay, freqs, FS, backend="stein", device=DEVICE)
    launches, split = fs.LAUNCHES, fs.SPLIT_LAUNCHES
    rescore_calls("wide1000", 1)
    want = caf_peak(needle, hay, freqs, FS, backend="xla", device=DEVICE)
    print(f"[rows] wide1000 chirp_0 over {WIDE_GRID} Hz: stein {got[0]:+.3f}"
          f" Hz, lag {got[1]}, value {got[2]:.6g}, K1 launches {launches} "
          f"({split} split); xla {want[0]:+.3f} Hz, lag {want[1]}, value "
          f"{want[2]:.6g}")
    check(launches == 1 and split == 1, "wide1000 did not launch K1 split")
    check(got[:2] == want[:2], "wide1000 stein off xla's (freq, lag)")
    check(abs(got[2] / want[2] - 1.0) <= 1e-4, "wide1000 exact value")
    needles, hays, _, _, truths = cfg3
    wide = np.linspace(-1000, 1000, 2000, endpoint=False).astype(np.float32)
    chunks = -(-hays.shape[-1] // STREAM_CHUNK)
    fs.LAUNCHES = fs.SPLIT_LAUNCHES = 0
    reset_rescore()
    s, _ = stream_through(hays[0], needles[0], wide, backend="stein")
    best = s.best()
    s_launches, s_split = fs.LAUNCHES, fs.SPLIT_LAUNCHES
    rescore_calls("the +-1000 Hz stream", 0)
    c, _ = stream_through(hays[0], needles[0], wide)
    cbest = c.best()
    print(f"[rows] stream3 at +-1000 Hz (2000 bins, 2B = "
          f"{s._lmat.shape[1]}, D = {s._group}): Stein stream {best}, K1 "
          f"launches {s_launches} ({s_split} split); cuFFT stream {cbest}; "
          f"want {truths[0]}")
    check(s_launches == s_split == chunks, "the +-1000 Hz Stein stream did "
                                           "not launch split K1 once a chunk")
    check(best[:2] == cbest[:2] == truths[0], "+-1000 Hz stream answer")
    check(abs(best[2] / cbest[2] - 1.0) <= 1e-4, "+-1000 Hz stream value")
    return launches + s_launches, err, (needle, hay, freqs, wide,
                                        needles[0], hays[0])


def phase_rows_times(rin, card):
    """K1 at 2B = 1024, 1536 and 1872 (D = 8, K = 400, 8192 lags, P = 1):
    wrapper and device ms, the plain version, bound and library
    yardstick; the wide1000 ``caf_peak`` call and the +-1000 Hz Stein
    stream, whole."""
    from caf_cookoff_tpu_torch import caf_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    needle, hay, freqs, wide, needle3, capture = rin
    rows = {}
    for b2 in ROW_SHAPES:
        ops, b, sup, m, _ = row_operands(b2, "a", b2)
        plan = fs.check_kernel_shape(b2, sup)
        fn = (lambda ops=ops, b=b, sup=sup, m=m: fs.fused_stein_rank(
            *ops, b, sup, m, want_idxs=False))
        k1, dev = cuda_median_ms(fn, 20, 3), device_ms(fn)
        plain = cuda_median_ms(lambda: surface_plain(
            ops, b, sup, m).max(dim=-1), 3, 1)
        bound, by, gflop = stein_bound_ms(ops, m)
        library = stage_b_matmul_ms(ops, m)
        shape = f"K=400 2B={b2} D=8 P=1 lags={m}, c={plan.cluster}"
        rows[str(b2)] = {"shape": shape, "cluster": plan.cluster,
                         "rows_a_block": plan.rows, "smem": plan.smem,
                         "ms": k1, "device_ms": dev, "plain_ms": plain,
                         "bound_ms": bound, "bound_by": by, "gflop": gflop,
                         "library_ms": library}
        for what, ms in ((f"K1 fused_stein_rank wrapper, {shape}", k1),
                         (f"K1 device time a call (torch.profiler), 2B={b2}",
                          dev),
                         (f"K1 plain version, 2B={b2}", plain),
                         (f"K1 bound ({by}, {gflop:.1f} GFLOP), 2B={b2}",
                          bound),
                         (f"K1 library yardstick: stage B alone as one bf16 "
                          f"torch.matmul, 2B={b2}", library)):
            print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    call = cuda_median_ms(lambda: caf_peak(
        needle, hay, freqs, FS, backend="stein", device=DEVICE), 20, 3)
    stream = cuda_median_ms(lambda: stream_through(
        capture, needle3, wide, backend="stein")[0].best(), 5, 1)
    print(f"[times] wide1000 caf_peak stein whole call (host included): "
          f"{call:.4f} ms  [{card}]")
    print(f"[times] stream3 at +-1000 Hz, whole Stein stream (build, "
          f"chunks, best()): {stream:.4f} ms  [{card}]")
    rows["wide1000_call_ms"] = call
    rows["stream_wide_ms"] = stream
    return rows


def config5_inputs():
    """Config 5 of ``bench_configs.py`` (``config5_virtual``'s recipe,
    the port's benchmark's builder): 8 pairs x 1024, 16384 lags, 64 bins
    over +-100 Hz, one emitter a pair -> (needles, haystacks, freqs,
    num_lags, truths)."""
    from caf_cookoff_tpu_torch.utils import bench_configs as bc

    return bc.build_config5()


def parallel_calls(cfgs, lcfgs, rcfgs, mesh):
    """The four K1 engines of ``parallel/`` at their full cells, each
    beside its single-device engine: name -> (sharded call, single
    call); the calls return host tuples."""
    from caf_cookoff_tpu_torch import (batched_stein_os_peak,
                                       batched_stein_os_peaks,
                                       batched_stein_peak, stein_rate_os_peak)
    from caf_cookoff_tpu_torch.parallel import (
        sharded_batched_stein_os_peaks, sharded_batched_stein_peak,
        sharded_stein_os_peak, sharded_stein_rate_os_peak)

    n2, h2, f2, _, _ = cfgs["config2"]
    n3, h3, f3, l3, _ = cfgs["config3"]
    n4, h4, f4, l4, _ = lcfgs["lattice4"]
    nr, hr, fr, rr, _ = rcfgs["rate3"]
    p4 = NUM_PEAKS["lattice4"]

    def one(x):
        return (float(x[0][0]), int(x[1][0]), float(x[2][0]))

    return {
        "config2": (
            lambda: sharded_batched_stein_peak(n2, h2, f2, FS, mesh),
            lambda: batched_stein_peak(n2, h2, f2, FS, device=DEVICE)),
        "config3": (
            lambda: sharded_stein_os_peak(n3[0], h3[0], f3, FS, mesh,
                                          num_lags=l3),
            lambda: one(batched_stein_os_peak(n3, h3, f3, FS, num_lags=l3,
                                              device=DEVICE))),
        "lattice4": (
            lambda: sharded_batched_stein_os_peaks(n4, h4, f4, FS, mesh,
                                                   num_peaks=p4, num_lags=l4),
            lambda: batched_stein_os_peaks(n4, h4, f4, FS, p4, num_lags=l4,
                                           device=DEVICE)),
        "rate3": (
            lambda: sharded_stein_rate_os_peak(nr, hr, fr, rr, FS, mesh),
            lambda: stein_rate_os_peak(nr, hr, fr, rr, FS, device=DEVICE)),
    }


def same_bits(a, b) -> bool:
    """Two host answers (tuples of numbers or arrays) equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def parallel_rank() -> int:
    """One rank of the eight-rank run (``--parallel-rank``): config 5,
    config 3 over time=8 and config 2 over pair=8 on ``cuda:0`` with
    gloo collectives; prints one ``RANK`` JSON line of answers, K1
    launches and seconds."""
    import_port()
    import datetime

    import torch.distributed as dist

    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.parallel import (
        batched_overlap_save_peak, make_mesh, sharded_batched_stein_peak,
        sharded_stein_os_peak)
    from caf_cookoff_tpu_torch.parallel import multihost

    multihost.initialize_cluster(backend="gloo",
                                 timeout=datetime.timedelta(seconds=300))
    dev = "cuda:0"
    n5, h5, f5, l5, _ = config5_inputs()
    cfgs = config_inputs()
    n2, h2, f2, _, _ = cfgs["config2"]
    n3, h3, f3, l3, _ = cfgs["config3"]
    out = {"rank": dist.get_rank()}
    runs = (
        ("config5", dict(pair=2, doppler=2, time=2), lambda m:
         batched_overlap_save_peak(n5, h5, f5, FS, m, num_lags=l5,
                                   backend="xla")),
        ("config3", dict(time=8), lambda m:
         sharded_stein_os_peak(n3[0], h3[0], f3, FS, m, num_lags=l3)),
        ("config2", dict(pair=8), lambda m:
         sharded_batched_stein_peak(n2, h2, f2, FS, m)))
    for name, shape, run in runs:
        mesh = make_mesh(device=dev, collectives="gloo", **shape)
        fs.LAUNCHES = 0
        t0 = time.perf_counter()
        got = run(mesh)
        first = time.perf_counter() - t0
        launches = fs.LAUNCHES
        t0 = time.perf_counter()
        run(mesh)
        second = time.perf_counter() - t0
        out[name] = {"answer": [np.asarray(x).tolist() if not np.isscalar(x)
                                else x for x in got],
                     "k1_launches": launches, "first_s": first,
                     "second_s": second, "mesh": repr(mesh)}
    dist.destroy_process_group()
    print("RANK " + json.dumps(out))
    return 0


def phase_parallel(cfgs, lcfgs, rcfgs, card):
    """``parallel/`` on the card: one NCCL rank through the four K1
    engines, bit for bit the single-device engines, then their whole
    calls interleaved; then eight gloo-collective ranks on the one card.
    Returns the K1 launches by path and the times."""
    import torch
    import torch.distributed as dist

    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.parallel import (collectives, make_mesh,
                                                multihost)

    multihost.initialize_cluster(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                 backend="nccl")
    mesh = make_mesh(device="cuda:0")
    check(mesh.backend == "nccl" and dist.get_backend() == "nccl",
          "the one-rank world is not on NCCL")
    print(f"[parallel] one rank: {mesh}")
    calls = parallel_calls(cfgs, lcfgs, rcfgs, mesh)
    launches, singles, times = {}, {}, {}
    for name, (sharded, single) in calls.items():
        fs.LAUNCHES = 0
        reset_rescore()
        got = sharded()
        launches[f"parallel 1 rank {name}"] = fs.LAUNCHES
        rescore_calls(f"parallel 1 rank {name}",
                      int(name in ("config2", "config3")))
        singles[name] = single()
        print(f"[parallel] 1 rank {name}: K1 launches "
              f"{launches[f'parallel 1 rank {name}']}; "
              f"bitwise the single-device engine: "
              f"{same_bits(got, singles[name])}")
        check(fs.LAUNCHES > 0, f"parallel {name} did not launch K1")
        check(same_bits(got, singles[name]),
              f"parallel {name} at one rank differs from the single-device "
              f"engine: {got} vs {singles[name]}")
    for name, (sharded, single) in calls.items():
        ts, tp = [], []
        for fn, acc in ((single, ts), (sharded, tp), (sharded, tp),
                        (single, ts)) * 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
        dev_p, ops_p = device_work(sharded, 3)
        dev_s, ops_s = device_work(single, 3)
        times[name] = {"one_rank_ms": statistics.median(tp),
                       "single_device_ms": statistics.median(ts),
                       "one_rank_device": {"ms": dev_p, "operations": ops_p},
                       "single_device_device": {"ms": dev_s,
                                                "operations": ops_s}}
        print(f"[times] parallel {name}: whole call at one NCCL rank "
              f"{times[name]['one_rank_ms']:.4f} ms, single-device engine "
              f"{times[name]['single_device_ms']:.4f} ms (medians of 10, "
              f"interleaved); device time {dev_p:.4f} ms in {ops_p:.1f} "
              f"device operations vs {dev_s:.4f} in {ops_s:.1f}  [{card}]")
    x = torch.zeros(64, device="cuda:0")
    gather_ms = cuda_median_ms(
        lambda: collectives.all_gather(x, "pair", mesh=mesh), 50)
    reduce_ms = cuda_median_ms(
        lambda: collectives.all_reduce(x, dist.ReduceOp.MAX, "pair",
                                       mesh=mesh), 50)
    times["nccl_all_gather_ms"] = gather_ms
    times["nccl_all_reduce_ms"] = reduce_ms
    print(f"[times] parallel one collective of 64 floats at one NCCL rank "
          f"(host included, median of 50): all_gather {gather_ms:.4f} ms, "
          f"all_reduce {reduce_ms:.4f} ms  [{card}]")
    dist.destroy_process_group()

    # Eight ranks on the one card: config 5's mesh and the K1 engines.
    n5, h5, f5, _, truths5 = config5_inputs()
    want3 = singles["config3"]
    want2 = singles["config2"]
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank"]
    t0 = time.perf_counter()
    outs = multihost.wait_local(multihost.launch_local(argv, 8), 600.0)
    wall = time.perf_counter() - t0
    ranks = []
    for r, (rc, text) in enumerate(outs):
        check(rc == 0, f"parallel rank {r} exited {rc}:\n{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        check(len(line) == 1, f"parallel rank {r} printed no result")
        ranks.append(json.loads(line[0][5:]))
    for res in ranks:
        r = res["rank"]
        fr, lg, _ = res["config5"]["answer"]
        got5 = [(float(f), int(x)) for f, x in zip(fr, lg)]
        check(got5 == truths5, f"rank {r} config 5 missed emitters: {got5}")
        got3 = tuple(res["config3"]["answer"])
        check(got3 == want3, f"rank {r} config 3 {got3} != single {want3}")
        fr, lg, vv = res["config2"]["answer"]
        check(list(fr) == list(want2[0]) and list(lg) == list(want2[1]),
              f"rank {r} config 2 answers differ from the single device")
        check(np.allclose(vv, want2[2], rtol=1e-5, atol=0),
              f"rank {r} config 2 values")
        for name in ("config3", "config2"):
            check(res[name]["k1_launches"] > 0,
                  f"rank {r} {name} did not launch K1")
    bits2 = all(np.array_equal(np.asarray(res["config2"]["answer"][2],
                                          np.float32), want2[2])
                for res in ranks)
    k1_8 = {name: [res[name]["k1_launches"] for res in ranks]
            for name in ("config3", "config2")}
    print(f"[parallel] 8 ranks on cuda:0 (gloo collectives): config 5 "
          f"{len(truths5)}/{len(truths5)} emitters on every rank; config 3 "
          f"over time=8 = the single-device answer bit for bit on every "
          f"rank; config 2 over pair=8 (freq, lag) equal, values within "
          f"1e-5 (bit for bit: {bits2}); K1 launches a rank {k1_8}")
    sec = {name: (max(res[name]["first_s"] for res in ranks),
                  max(res[name]["second_s"] for res in ranks))
           for name in ("config5", "config3", "config2")}
    print(f"[times] parallel 8 ranks sharing one card: whole run "
          f"{wall:.3f} s (8 process starts, imports, inputs, 3 workloads "
          f"twice); slowest rank's calls (first, second) s: {sec}; ranks "
          f"that share one card, not a scaling number  [{card}]")
    for name, counts in k1_8.items():
        launches[f"parallel 8 ranks {name}"] = sum(counts)
    return launches, {"one_rank": times, "eight_rank_wall_s": wall,
                      "eight_rank_calls_s": sec,
                      "eight_rank_config2_bitwise": bits2}


def phase_kernel_k4():
    """K4 against its plain version at (416, 8192), bit for bit, in both
    compiled sweep counts; then its own path, ``roofline.measure``, with
    the launch count zeroed just before."""
    import torch

    from caf_cookoff_tpu_torch.utils import roofline as rf

    errs = []
    for sweeps in (rf.REPEAT, 1):
        got = rf.epilogue(sweeps=sweeps, seed=0.25, device=DEVICE)
        want = rf.epilogue_plain(sweeps=sweeps, seed=0.25, device=DEVICE)
        torch.cuda.synchronize()
        errs.append((got - want).abs().max().item())
        same = int((got == want).sum().item())
        print(f"[kernel] K4 epilogue {rf.KP}x{rf.M}, {sweeps} sweep(s): "
              f"max abs err {errs[-1]:.3g}, bit-identical rows {same} of "
              f"{rf.KP}")
        check(same == rf.KP, f"K4 ({sweeps} sweeps) off its plain version")
    rf.LAUNCHES = 0
    meas = rf.measure()
    launches = rf.LAUNCHES
    print(f"[kernel] K4 roofline.measure: {launches} launches, "
          f"{meas['ops_per_s'] / 1e12:.3f} T f32 ops/s, epilogue floor "
          f"{meas['epilogue_floor_us']:.3f} us")
    check(launches > 0, "roofline.measure did not launch K4")
    # A rate past the f32 peak means the compiler folded sweeps away.
    check(0 < meas["ops_per_s"] <= F32_FLOPS,
          "K4's operation rate is past the card's f32 peak")
    return meas, launches, max(errs)


def phase_rate_times(rcfgs, rshape, rate_launches, refine_inputs, card):
    """K1 (f) and (e+f) at rate3's shape (wrapper, plain version, bound;
    also three launches of 918 rows, the JAX package's row budget), the
    rate engines' whole calls and the refiners'."""
    from caf_cookoff_tpu_torch import (rate_overlap_save_peak, refine_peak,
                                       refine_peak_rate, stein_rate_os_peak,
                                       stein_rate_os_peaks)
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    ops, b, sup, m, modes, shape, sep, lag1 = rshape
    needle, hay, freqs, rates, ((r_t, f_t, lag_t),) = rcfgs["rate3"]
    t = {}
    bound, by, gflop = stein_bound_ms(ops, m, modes)
    t["k1"] = cuda_median_ms(lambda: fs.fused_stein_rank(*ops, b, sup, m,
                                                         **modes), 10, 3)
    third = ops[0].shape[0] // 3
    t["k1_three"] = cuda_median_ms(lambda: [fs.fused_stein_rank(
        ops[0][i * third:(i + 1) * third], ops[1][i * third:(i + 1) * third],
        *ops[2:], b, sup, m, **modes) for i in range(3)], 10, 3)
    t["k1_plain"] = cuda_median_ms(lambda: surface_plain(
        ops, b, sup, m, **modes).max(dim=-1), 3, 1)
    t["k1_top2"] = cuda_median_ms(lambda: fs.fused_stein_rank(
        *ops, b, sup, m, want_top2=True, sep=sep, **modes), 10, 3)
    t["k1_top2_plain"] = cuda_median_ms(lambda: top2_plain(
        ops, b, sup, m, sep, **modes), 3, 1)
    t["stein_rate_os_peak"] = cuda_median_ms(lambda: stein_rate_os_peak(
        needle, hay, freqs, rates, FS, device=DEVICE), 5, 1)
    t["stein_rate_os_peaks"] = cuda_median_ms(lambda: stein_rate_os_peaks(
        *rcfgs["ratelat3"][:4], FS, 3, device=DEVICE), 5, 1)
    t["rate_overlap_save_peak"] = cuda_median_ms(
        lambda: rate_overlap_save_peak(needle, hay, freqs, rates, FS,
                                       device=DEVICE), 5, 1)
    n0, h0, f0, lag0 = refine_inputs[0]
    t["refine_peak"] = cuda_median_ms(lambda: refine_peak(
        n0, h0, f0, lag0, FS, coarse_step_hz=0.5, device=DEVICE), 20, 3)
    t["refine_peak_rate"] = cuda_median_ms(lambda: refine_peak_rate(
        needle, hay, f_t, lag_t, FS, rate0_hz_per_s=r_t,
        max_rate_hz_per_s=float(rates[1] - rates[0]),
        coarse_step_hz=float(freqs[1] - freqs[0]), device=DEVICE), 20, 3)
    top2_bound = stein_bound_ms(ops, m, modes, top2=True)
    t["library"] = stage_b_matmul_ms(ops, m, modes)
    rows = {"shape": shape, "sep": sep, "launches": rate_launches,
            "ms": t["k1"], "ms_three_launches_918_rows": t["k1_three"],
            "plain_ms": t["k1_plain"], "bound_ms": bound, "bound_by": by,
            "gflop": gflop, "library_ms": t["library"],
            "top2_ms": t["k1_top2"],
            "top2_plain_ms": t["k1_top2_plain"],
            "top2_bound_ms": top2_bound[0],
            "recomputed_tiles": recompute_tiles(lag1, sep, m),
            "call_ms": {k: t[k] for k in (
                "stein_rate_os_peak", "stein_rate_os_peaks",
                "rate_overlap_save_peak", "refine_peak",
                "refine_peak_rate")}}
    for what, ms in (
            (f"K1 (c+d+f) fused_stein_rank wrapper, rate3: {shape}", t["k1"]),
            ("K1 (c+d+f) in three launches of 918 rows (the JAX package's "
             "row budget), rate3", t["k1_three"]),
            ("K1 (c+d+f) plain version (surface with the kernel's roundings "
             "and sums + max), rate3", t["k1_plain"]),
            (f"K1 (c+d+f) bound ({by}, {gflop:.1f} GFLOP), rate3", bound),
            ("K1 library yardstick: stage B alone as one bf16 torch.matmul, "
             "rate3", t["library"]),
            (f"K1 (c+d+e+f) wrapper, rate3 sep={sep}", t["k1_top2"]),
            ("K1 (c+d+e+f) plain version (+ top2_separated), rate3",
             t["k1_top2_plain"]),
            ("stein_rate_os_peak whole call, rate3 (host included)",
             t["stein_rate_os_peak"]),
            ("stein_rate_os_peaks whole call, ratelat3, 3 slots (host "
             "included)", t["stein_rate_os_peaks"]),
            ("rate_overlap_save_peak whole call, rate3 (the serial cuFFT "
             "yardstick)", t["rate_overlap_save_peak"]),
            ("refine_peak chirp_0 (host included)", t["refine_peak"]),
            ("refine_peak_rate at rate3's emitter (host f64 polish "
             "included)", t["refine_peak_rate"])):
        print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    return rows


def phase_bench(card):
    """The port's benchmark (``utils/bench_configs``) over every cell at
    full width, 3 interleaved rounds, in a process of its own, as a user
    runs it (late in a process that has profiled many times,
    ``torch.profiler`` loses device records): each cell's gate must pass
    (a failed gate fails the run), then one line a (cell, engine) with
    its median, best, spread, device time and host share, and no graph
    captured during the timed rounds."""
    import subprocess

    out = ROOT / "build" / "chip_smoke_bench.json"
    out.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "caf_cookoff_tpu_torch.utils.bench_configs",
         "--rounds", "3", "--out", str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    check(proc.returncode == 0,
          f"[bench] exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = json.loads(out.read_text())["lines"]
    for line in lines:
        print(f"[bench] {json.dumps(line)}")
    timed = [ln for ln in lines if ln.get("timed", True)]
    check(len(lines) >= 12 and all(ln["gate"] == "passed" for ln in lines)
          and all(ln["median_ms"] > 0 and ln["device_ms"] > 0
                  and ln["rounds"] == 3 for ln in timed),
          "[bench] lines")
    check(all(ln["captures"] == 0 for ln in timed),
          "[bench] a compiled call captured again during the timed rounds "
          "(a key evicted from ops/_graph's cache)")
    print(f"[bench] {len(timed)} timed (cell, engine) lines and "
          f"{len(lines) - len(timed)} gate-only cell(s) in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    return lines


def phase_scaling(card):
    """The scaling harness (``utils/bench_scaling``) at N = 1 on NCCL in
    a child process, ``doppler`` and ``time``: gated, timed, and no
    efficiency (one card gives no scaling number)."""
    from caf_cookoff_tpu_torch.utils import bench_scaling as bs

    try:
        lines = bs.run(["doppler", "time"], [1], DEVICE, rounds=3)
    except bs.GateError as exc:
        check(False, f"[scaling] gate: {exc}")
    for line in lines:
        print(f"[scaling] {json.dumps(line)}")
    check(len(lines) == 2 and all(
        ln["gate"] == "passed" and ln["collectives"] == "nccl"
        and ln["full_ms"] > 0 and ln["compute_ms"] > 0
        and "efficiency" not in ln for ln in lines), "[scaling] lines")
    print(f"[scaling] doppler and time at one NCCL rank: full / compute "
          f"ms {[(ln['full_ms'], ln['compute_ms']) for ln in lines]}  "
          f"[{card}]")
    return lines


# Partial-overlap workloads: (n, lag, (start, stop, step) Hz, emitter Hz)
PARTIAL = ((4096, 3900, (0.0, 50.0, 0.25), 30.0),
           (257, 145, (-6.0, 26.0, 1.0), 19.0),
           (512, 471, (-6.0, 17.0, 1.0), 5.0),
           (777, 656, (-2.0, 6.0, 0.5), 1.0),
           (4096, 3500, (0.0, 50.0, 0.25), 30.0))


def phase_fault2():
    """Partial-overlap workloads (only the needle's first n - lag samples
    reach the haystack) through ``caf_peak(backend="stein")`` on the card
    and ``backend="xla"``: reported, not gated.  K1 rounds the synthesis
    weights to bf16 as the TPU kernel does, so on surfaces this flat its
    8 + 4 candidates can miss the bin the exact surface peaks in."""
    from caf_cookoff_tpu_torch import caf_peak

    same = 0
    for n, lag, grid, f_hz in PARTIAL:
        freqs = np.arange(*grid, dtype=np.float32)
        for seed in range(3):
            rng = np.random.default_rng(seed)
            needle = (rng.standard_normal(n)
                      + 1j * rng.standard_normal(n)).astype(np.complex64)
            hay = (1e-3 * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))
                   ).astype(np.complex64)
            t = np.arange(n - lag)
            hay[lag:] += (needle[:n - lag] * np.exp(
                2j * np.pi * f_hz * (lag + t) / FS)).astype(np.complex64)
            st = caf_peak(needle, hay, freqs, FS, backend="stein",
                          device=DEVICE)
            xl = caf_peak(needle, hay, freqs, FS, backend="xla",
                          device=DEVICE)
            same += st[:2] == xl[:2]
            print(f"[fault2] n={n} lag={lag} emitter {f_hz} Hz seed {seed}: "
                  f"stein ({st[0]}, {st[1]}), xla ({xl[0]}, {xl[1]})")
    print(f"[fault2] stein = xla (freq, lag) in {same} of "
          f"{3 * len(PARTIAL)} (reported, not gated: K1's bf16 weights)")
    return same


def main() -> int:
    import_port()
    name, card = phase_device()
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures

    pairs = ensure_fixtures(ROOT / "data")
    phase_build()
    head, err1 = phase_kernel_stein(pairs)
    fb_head, err2, err3 = phase_kernel_filterbank(pairs)
    rescore = phase_rescore(pairs, card)
    inputs = golden_inputs(pairs)
    launches1, fb = phase_main_stein(inputs)
    launches2, launches3 = phase_main_pallas(inputs, fb)
    cfgs = config_inputs()
    err_modes = phase_kernel_modes(cfgs["config3"])
    config_launches = {name: run_config(name, cfg)
                       for name, cfg in cfgs.items()}
    phase_graph(inputs, cfgs, card)
    phase_graph_streams(cfgs, card)
    lcfgs = lattice_inputs()
    err_top2, top2_shapes = phase_kernel_top2(lcfgs)
    lattice_launches = {name: run_lattice(name, cfg)
                        for name, cfg in lcfgs.items()}
    rcfgs = rate_inputs()
    rshape, err_rate = phase_kernel_rate(rcfgs)
    rate_launches = {name: run_rate(name, rcfgs[name])[0]
                     for name in ("rate3", "ratelat3", "rate1")}
    del rate_launches["rate1"]      # the cuFFT dechirp bank: no kernel
    refine_inputs = phase_refine(pairs)
    sin = stream_inputs()
    stream_launches, err_stream = phase_stream(sin)
    rows_launches, err_rows, rin = phase_rows(pairs, cfgs["config3"])
    par_launches, par = phase_parallel(cfgs, lcfgs, rcfgs, card)
    k4, k4_launches, err4 = phase_kernel_k4()
    t = phase_times(head, fb_head, inputs, card)
    configs = phase_config_times(cfgs, config_launches, card)
    lattices = phase_lattice_times(lcfgs, top2_shapes, lattice_launches, card)
    for lattice, err in err_top2.items():
        lattices[lattice]["max_abs_err"] = err
    rates = phase_rate_times(rcfgs, rshape, rate_launches, refine_inputs,
                             card)
    rates["max_abs_err"] = err_rate
    stream = phase_stream_times(sin, card)
    stream.update(launches=stream_launches, max_abs_err=err_stream)
    rows = phase_rows_times(rin, card)
    rows.update(launches=rows_launches, max_abs_err=err_rows)
    phase_bench(card)
    phase_scaling(card)
    phase_fault2()
    import torch

    from caf_cookoff_tpu_torch.ops import fused_stein as fs
    from caf_cookoff_tpu_torch.utils import roofline as rf

    k4_plain = cuda_median_ms(lambda: rf.epilogue_plain(device=DEVICE), 10, 2)
    for what, ms in (
            (f"K4 epilogue ({k4['shape']}), 64 sweeps, device time a "
             f"launch (CUDA graph of 20)", k4["ms"]),
            ("K4 epilogue, 1 sweep, device time a launch", k4["ms_one_sweep"]),
            ("K4 plain version (torch, 64 sweeps)", k4_plain)):
        print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    k, n = fb_head[2].shape[0], len(inputs[0][0])
    occ2 = filterbank_occupancy(k, fb_head[3], surface=False)
    occ3 = filterbank_occupancy(k, fb_head[3], surface=True)
    print(f"[occupancy] K2 at {k}x{fb_head[3]}: {occ2}; K3: {occ3}  [{card}]")
    bound1, by1, _ = stein_bound_ms(head[0], head[3])
    bound2, by2 = filterbank_bound_ms(k, n, fb_head[3], surface=False)
    bound3, by3 = filterbank_bound_ms(k, n, fb_head[3], surface=True)
    bound4, by4, gop4 = k4_bound_ms()
    print(f"[bounds] K4: {bound4:.6f} ms ({by4}, {gop4:.3f} G non-fma f32 "
          f"operations at half the published H100 f32 peak); measured "
          f"{k4['ops_per_s'] / 1e12:.3f} T ops/s, epilogue floor "
          f"{k4['epilogue_floor_us']:.3f} us  [{card}]")
    src = "caf_cookoff_tpu_torch/csrc/"
    print(json.dumps({"kernels": [{
        "name": "fused_stein_rank", "route": "cuda",
        "source": src + "fused_stein.cu",
        "replaces": "caf_cookoff_tpu/ops/pallas_stein.py:71",
        "launches": (launches1 + sum(config_launches.values())
                     + sum(lattice_launches.values())
                     + sum(rate_launches.values()) + stream_launches
                     + rows_launches + sum(par_launches.values())),
        "max_abs_err": err1,
        "ms": t["k1"], "plain_ms": t["k1_plain"],
        "bound_ms": bound1, "bound_by": by1, "library_ms": t["k1_matmul"],
        "library": "stage B alone as one bf16 torch.matmul (no one call "
                   "ranks)",
        "device_ms": t["k1_device"],
        "bound_c": fs.BOUND_C,
        "modes": "(a) one pair, (b) pairs, (c) share_h, (d) windows + "
                 "num_valid, (c+d), (e) want_top2 with (b) and (c+d), "
                 "(f) rate-major synthesis rows with (c+d) and (c+d+e); "
                 "P = 1 with num_valid and with (e) once a chunk in the "
                 "stream; past 864 rows (D = 8) G's rows shared over a "
                 "cluster of 2-16 blocks a lag tile, in every mode",
        "launches_by_path": {"stein goldens": launches1,
                             **config_launches, **lattice_launches,
                             **rate_launches, "stream3": stream_launches,
                             "wide1000 and the +-1000 Hz stream":
                                 rows_launches,
                             **par_launches},
        "max_abs_err_modes_config3": err_modes,
        "configs": configs,
        "top2": lattices,
        "rate": rates,
        "stream": stream,
        "rows": rows,
        "parallel": par,
    }, {
        "name": "caf_peak_rows", "route": "cuda",
        "source": src + "caf_filterbank.cu",
        "replaces": "caf_cookoff_tpu/ops/pallas_caf.py:162",
        "launches": launches2, "max_abs_err": err2,
        "ms": t["k2"], "plain_ms": t["k2_plain"],
        "bound_ms": bound2, "bound_by": by2, "library_ms": t["k2_library"],
        "library": "cuFFT filterbank rows + |.|^2 + per-bin max",
        "launch_alone_ms": t["k2_alone"],
        "launch_device_ms": t["k2_device"],
        "launch_alone_k8_ms": t["k2_alone_k8"],
        "launch_device_k8_ms": t["k2_device_k8"],
        "launch_device_one_wave_ms": t["k2_device_wave"],
        "one_wave_bins": t["k_wave"],
        "blocks_per_sm": occ2["blocks_per_sm"], "cluster": occ2["cluster"],
        "waves": occ2["waves"],
    }, {
        "name": "caf_surface", "route": "cuda",
        "source": src + "caf_filterbank.cu",
        "replaces": "caf_cookoff_tpu/ops/pallas_caf.py:260",
        "launches": launches3, "max_abs_err": err3,
        "ms": t["k3"], "plain_ms": t["k3_plain"],
        "bound_ms": bound3, "bound_by": by3, "library_ms": t["k3_library"],
        "library": "cuFFT filterbank rows + |.|^2",
        "launch_alone_ms": t["k3_alone"],
        "launch_device_ms": t["k3_device"],
        "blocks_per_sm": occ3["blocks_per_sm"], "cluster": occ3["cluster"],
        "waves": occ3["waves"],
    }, {
        "name": "stein_rescore", "route": "cuda",
        "source": src + "stein_rescore.cu",
        "replaces": "the XLA re-score of caf_cookoff_tpu/models/stein.py:225 "
                    "(no Pallas kernel)",
        "library": "the plain torch + cuFFT chain replayed in a CUDA graph",
        "launches": sum(RESCORE_BY_PATH.values()),
        "launches_by_path": RESCORE_BY_PATH,
        "cells": rescore,
    }, {
        "name": "epilogue_roofline", "route": "cuda",
        "source": src + "roofline_epilogue.cu",
        "replaces": "docs/roofline_vpu.py:57",
        "launches": k4_launches, "max_abs_err": err4,
        "ms": k4["ms"], "plain_ms": k4_plain,
        "bound_ms": bound4, "bound_by": by4, "library_ms": None,
        "ms_one_sweep": k4["ms_one_sweep"], "ops_per_s": k4["ops_per_s"],
        "ops_per_s_whole_launch": k4["ops_per_s_whole_launch"],
        "epilogue_floor_us": k4["epilogue_floor_us"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--parallel-rank"]:
        sys.exit(parallel_rank())
    sys.exit(main())
