#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``caf_cookoff_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device — fails unless torch sees a CUDA card; prints the card and
   ``nvidia-smi``'s name and power limit; TF32 off for matmuls and cuDNN.
2. build  — compiles ``csrc/fused_stein.cu`` with nvcc from this checkout.
3. kernel — the fused Stein rank kernel against its plain PyTorch version
   (same bf16 roundings) on the card: chirp_0's operands at the main
   path's shape (400 bins, N = 4096, M = 8192, D = 64), a random two-pair
   shape, and the cross-tile tie case (lowest lag wins).
4. main   — the ten golden fixtures through ``caf_peak(backend="stein",
   device="cuda")``; every answer must be exact and the kernel's launch
   count must show the path went through it; chirp_0 also through the
   cuFFT filterbank (``backend="xla"``) and against the CPU route.
5. times  — CUDA-event medians, after warm-up, of the kernel's wrapper
   and of its plain version at the main path's shape, and of whole
   ``caf_peak`` calls (host included), each printed beside the card's
   name and power limit.

Then a JSON line describing each kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  Fixtures are generated into ``data/`` when missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
FS = 48_000.0
# Kernel vs plain version with the same bf16 roundings: both sum the same
# bf16-exact products in f32 and differ only in the order of the sums
# (1.2e-7 measured on the H100).  A kernel that skips a rounding, sums in
# bf16 or drops a segment is off by 1e-3 or more.
RTOL = 1e-5
LAG_SHARE = 0.99    # least share of bins whose lag equals the plain argmax
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
    print(f"[build] fused_stein.cu {how} and loaded in {seconds:.1f} s")
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


def compare(label, ops, b, sup, m):
    """Kernel vs plain version on one operand set; returns the max
    absolute value error."""
    import torch

    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    kv, ki = fs.fused_stein_rank(*ops, b, sup, m)
    surf = fs.coarse_surface_plain(*ops, b, sup, m, emulate_bf16=True)
    torch.cuda.synchronize()
    pv, pi = surf.max(dim=-1)
    pv, pi = pv.T, pi.T
    check(bool(torch.isfinite(kv).all()), f"{label}: non-finite values")
    rel = ((kv - pv).abs() / pv).max().item()
    at = torch.gather(surf, 2, ki.T.long()[..., None])[..., 0].T
    lag_ok = bool((at >= (1 - RTOL) * pv).all())
    share = (ki == pi).float().mean().item()
    err = (kv - pv).abs().max().item()
    print(f"[kernel] {label}: K={kv.shape[0]} P={kv.shape[1]} M={m}: "
          f"max rel err {rel:.3e} (tol {RTOL}), max abs err {err:.4g}, "
          f"plain value at kernel lag >= (1-{RTOL}) x max: {lag_ok}, "
          f"exact lag matches {share:.4f} (least {LAG_SHARE})")
    check(rel <= RTOL, f"{label}: kernel values off the plain version")
    check(lag_ok, f"{label}: kernel lag not a (near-)maximum")
    check(share >= LAG_SHARE, f"{label}: kernel lags off the plain argmax")
    return err


def phase_kernel(pairs):
    import torch

    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    n0, h0 = load_pair(pairs, 0)
    head = headline_operands(n0, h0, DEVICE)
    err = compare("chirp_0 headline", *head)
    rng = np.random.default_rng(0)
    compare("random P=2", *random_operands(rng, 2, 2048, 97, 4096, 32,
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
    print(f"[kernel] tie case: zero-doppler bin lag {tie_lag} (want 100)")
    check(tie_lag == 100, "cross-tile tie did not resolve to the lowest lag")
    return head, err


def phase_main(pairs):
    from caf_cookoff_tpu_torch import FreqGrid, caf_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    inputs = []
    for idx, grid, want_f, want_l in GOLDEN:
        needle, hay = load_pair(pairs, idx)
        inputs.append((needle, hay, FreqGrid(*grid).frequencies(np.float32),
                       want_f, want_l))
    fs.LAUNCHES = 0
    answers = [caf_peak(n, h, f, FS, backend="stein", device=DEVICE)
               for n, h, f, _, _ in inputs]
    launches = fs.LAUNCHES
    for (idx, *_), (_, _, _, want_f, want_l), (freq, lag, val) in zip(
            GOLDEN, inputs, answers):
        print(f"[main] chirp_{idx}: {freq:+.3f} Hz, lag {lag}, "
              f"value {val:.6g} (want {want_f:+.3f} Hz, lag {want_l})")
        check(abs(freq - want_f) <= 1e-4 and lag == want_l
              and np.isfinite(val) and val > 0, f"chirp_{idx} answer")
    print(f"[main] fused_stein_rank launches over the 10 goldens: "
          f"{launches}")
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
    return launches, inputs


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


def phase_times(head, inputs, card):
    from caf_cookoff_tpu_torch import BENCH_GRID, caf_peak
    from caf_cookoff_tpu_torch.ops import fused_stein as fs

    ops, b, sup, m = head
    n0, h0 = inputs[0][0], inputs[0][1]
    bench = BENCH_GRID.frequencies(np.float32)
    shape = "K=400 M=8192 D=64 P=1"
    kernel_ms = cuda_median_ms(
        lambda: fs.fused_stein_rank(*ops, b, sup, m, want_idxs=False), 100)
    plain_ms = cuda_median_ms(
        lambda: fs.coarse_rank_plain(*ops, b, sup, m, emulate_bf16=True), 50)
    main_ms = cuda_median_ms(
        lambda: caf_peak(n0, h0, bench, FS, backend="stein", device=DEVICE),
        50)
    for what, ms in (
            (f"fused_stein_rank kernel wrapper (bf16 casts + 3 launches), "
             f"{shape}", kernel_ms),
            (f"coarse_rank_plain (same roundings), {shape}", plain_ms),
            ("caf_peak stein main path, 400x8192, per surface incl. host",
             main_ms)):
        print(f"[times] {what}: {ms:.4f} ms  [{card}]")
    return kernel_ms, plain_ms


def main() -> int:
    import_port()
    name, card = phase_device()
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures

    pairs = ensure_fixtures(ROOT / "data")
    phase_build()
    head, err = phase_kernel(pairs)
    launches, inputs = phase_main(pairs)
    kernel_ms, plain_ms = phase_times(head, inputs, card)
    import torch

    print(json.dumps({"kernels": [{
        "name": "fused_stein_rank",
        "route": "cuda",
        "source": "caf_cookoff_tpu_torch/csrc/fused_stein.cu",
        "replaces": "caf_cookoff_tpu/ops/pallas_stein.py:71",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
