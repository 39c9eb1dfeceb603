"""Benchmark harness: the README-style strategy table on a CUDA card.

The counterpart of the JAX package's ``utils/bench``.  ``ALL_BACKENDS``
and :func:`flops_model` are the JAX package's, number for number.
:func:`run_benchmarks` gates every backend on its golden answer before
it times it, then times whole ``caf_peak`` calls (host included) with
CUDA events after warm-up.  Rows carry the card's name and its
``nvidia-smi`` power limit, and ``tflops`` / ``mfu_pct`` against the
card's published dense bf16 peak where the card is known.  The JAX
package's hardware-pass column (``hw_mfu_pct``, from ``_tier_passes``)
is not ported: no tier of the port runs a multi-pass product.  A
measurement needs a card: a non-CUDA device raises.
"""

from __future__ import annotations

import math
import pathlib
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import BENCH_GRID, FreqGrid, is_pow2, \
    xcor_length

ALL_BACKENDS = ("xla", "matmul", "matmul-highest", "matmul-bf16",
                "pallas", "pallas-bf16", "pallas-refine", "stein-raw",
                "stein")

# Published dense bf16 tensor-core peak (FLOP/s) by device-name
# substring, at the card's full power limit (NVIDIA's H100 data sheet).
_BF16_PEAKS = {"h100": 989e12}


def factor_two(n: int):
    """n = n1 * n2 with factors near sqrt(n) (the JAX package's four-step
    DFT split, used by :func:`flops_model`)."""
    if is_pow2(n):
        half = n.bit_length() - 1
        n1 = 1 << (half // 2)
        return n1, n // n1
    best = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            best = d
    return best, n // best


def flops_model(backend: str, k: int, needle_len: int, m: int,
                block_len: int = 64) -> float:
    """Algorithmic FLOPs of one surface+peak for a backend.

    Transform models: matmul-DFT four-step = 8*M*(n1+n2) FLOP/transform
    (two stacked real matmuls) + 6M twiddle; complex FFT = 5*M*log2(M).
    Elementwise stages (phasor bank, spectral product, |.|^2, argmax)
    add ~O(K*M) FLOPs, included at their dominant terms.
    """
    n1, n2 = factor_two(m)
    t_mm = 8.0 * m * (n1 + n2) + 6.0 * m
    t_fft = 5.0 * m * math.log2(m)
    elementwise = k * m * (6.0 + 3.0 + 2.0)   # product, mag2, reduce
    phasor = 2.0 * k * needle_len * 8.0       # sincos + shift multiply
    if backend.startswith("stein"):
        b = -(-needle_len // block_len)
        if backend == "stein-raw":     # unfused: FFT-based stage A
            stage_a = (2 * b + 1) * t_mm
            refine = 0.0
        else:
            # Fused stage A: one direct-correlation dot, 2B x 2*D x span
            # real MACs (span ~ N + M).
            stage_a = 2.0 * (2 * b) * (2 * block_len) * (needle_len + m)
            refine = 8 * (2 * t_mm + 8.0 * m)
        synth = 8.0 * k * b * m
        return stage_a + synth + refine + k * m * 3.0
    transform = t_fft if backend == "xla" else t_mm
    base = (2 * k + 1) * transform + elementwise + phasor
    if backend == "pallas-refine":
        # sweep + re-score of TILE_BINS candidates at 3-pass
        return base + 8 * (2 * t_mm * 3.0 + 8.0 * m)
    return base


def nvidia_smi_card() -> Optional[str]:
    """``nvidia-smi``'s "name, power limit" of the first card, or None
    where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _require_card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"benchmarks time a CUDA card; got device "
                           f"{dev} (torch sees a card: "
                           f"{torch.cuda.is_available()})")
    return dev


def _mfu(flops: float, ms: float, card_name: str) -> Dict:
    """Achieved TFLOP/s and % of the card's dense bf16 peak; empty for
    a card not in the table."""
    peak = next((v for s, v in _BF16_PEAKS.items()
                 if s in card_name.lower()), None)
    if peak is None:
        return {}
    tflops = flops / (ms * 1e-3) / 1e12
    return {"tflops": round(tflops, 2),
            "mfu_pct": round(100.0 * tflops * 1e12 / peak, 2)}


def _events_ms(fn, iters: int, rounds: int, warmup: int = 5) -> float:
    """Best over ``rounds`` of the mean ms of ``iters`` calls of ``fn``
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / iters)
    return best


def apply_shift_microbench(num_samples: int = 8192, iters: int = 20_000,
                           reps: int = 4, device="cuda") -> Dict:
    """The README's ``apply_shift`` micro-comparison (one 8192-sample
    frequency translation; rust 120 us is the reference's best), timed
    on the card with CUDA events."""
    dev = _require_card(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.standard_normal(num_samples)
         + 1j * rng.standard_normal(num_samples)).astype(np.complex64)
    ).to(dev)
    n_idx = torch.arange(num_samples, dtype=torch.float32, device=dev)
    rate = float(np.float32(2 * np.pi * 100.0 / 48e3))

    def shift():
        phase = rate * n_idx
        return x * torch.complex(torch.cos(phase), torch.sin(phase))

    us = _events_ms(shift, iters, reps) * 1e3
    return {
        "strategy": "apply_shift+cuda",
        "us_per_call": round(us, 3),
        "samples": num_samples,
        "reference_best_us": 120.0,  # rust, the reference README
        "device": torch.cuda.get_device_name(dev),
        "power_limit": nvidia_smi_card(),
    }


def run_benchmarks(grid: FreqGrid = BENCH_GRID,
                   sample_rate: float = 48e3,
                   rounds: int = 3,
                   backends: Sequence[str] = ("xla", "matmul", "stein"),
                   data_dir: str = "data",
                   iters: int = 200,
                   device="cuda") -> List[Dict]:
    """Time every requested backend on the chirp_0 workload.

    Each backend asserts its golden answer first (a silently-wrong
    backend never posts a time; the single-pass bf16 tier names are
    labelled "one-bin-off" instead of failed, as in the JAX package),
    then ``rounds`` x ``iters`` whole ``caf_peak`` calls are timed with
    CUDA events; ``ms`` is the best round's mean.
    """
    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

    dev = _require_card(device)
    if list(backends) == ["all"]:
        backends = ALL_BACKENDS
    needle_path, haystack_path = ensure_fixtures(pathlib.Path(data_dir))[0]
    needle = load_c64(needle_path)
    haystack = load_c64(haystack_path, count=len(needle))
    truth = parse_ground_truth(haystack_path)
    freqs = grid.frequencies(np.float32)
    # Gate only where the grid can resolve the fixture: the truth in
    # range and the step inside the doppler mainlobe (fs/N).
    covers_truth = (freqs[0] - 1e-9 <= truth.freq_hz
                    <= freqs[-1] + grid.step_hz
                    and grid.step_hz <= sample_rate / len(needle))
    n_t = torch.from_numpy(needle).to(dev)
    h_t = torch.from_numpy(haystack).to(dev)
    card = torch.cuda.get_device_name(dev)
    power = nvidia_smi_card()
    xcor_len = xcor_length(len(needle))

    results = []
    for backend in backends:
        row = {"strategy": f"{backend}+cuda",
               "surface": f"{len(freqs)}x{xcor_len}",
               "device": card, "power_limit": power}
        try:
            if covers_truth:
                freq, lag, _ = caf_peak(n_t, h_t, freqs, sample_rate,
                                        backend=backend, device=dev)
                golden = (abs(freq - truth.freq_hz) <= grid.step_hz
                          and lag == truth.lag_samples)
                if not golden and backend not in ("matmul-bf16",
                                                  "pallas-bf16"):
                    raise AssertionError(
                        f"golden check failed: got ({freq}, {lag}), "
                        f"truth ({truth.freq_hz}, {truth.lag_samples})")
                row["golden"] = "exact" if golden else "one-bin-off"
            row["ms"] = round(_events_ms(
                lambda: caf_peak(n_t, h_t, freqs, sample_rate,
                                 backend=backend, device=dev),
                iters, max(rounds, 2)), 4)
            row.update(_mfu(flops_model(backend, len(freqs), len(needle),
                                        xcor_len), row["ms"], card))
        except Exception as exc:   # the row reports it; the table goes on
            row["ms"] = float("nan")
            row["error"] = f"{type(exc).__name__}: {str(exc)[:120]}"
        results.append(row)
    return results
