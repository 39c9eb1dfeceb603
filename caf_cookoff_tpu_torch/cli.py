"""Command-line interface (``generate``, ``run``, ``bench``, ``selftest``,
``info``).

  python -m caf_cookoff_tpu_torch generate --out DIR
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 HAYSTACK.c64 [--backend stein]
  python -m caf_cookoff_tpu_torch bench [--backends xla,pallas-refine,stein]
  python -m caf_cookoff_tpu_torch selftest [--backend pallas-refine]
  python -m caf_cookoff_tpu_torch info

``run`` truncates the haystack to the needle length, as the reference
does, and prints the reference's two result lines.  Every verb that
computes runs on the CUDA card unless ``--device cpu`` asks for the CPU;
``bench`` times the card only.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from caf_cookoff_tpu_torch.config import (BACKENDS, BENCH_GRID,
                                          DEFAULT_SAMPLE_RATE, FreqGrid)

_DEVICE_HELP = ("torch device (default: the CUDA card; without one the "
                "command fails unless --device cpu asks for the CPU)")
_BACKEND_HELP = ("auto/xla/matmul*: filterbank on torch.fft; pallas "
                 "(-refine, -bf16): fused filterbank kernel, every tier "
                 "in f32; stein: segmented engine with the fused rank "
                 "kernel and exact re-score")


def _add_grid_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--freq-start", type=float, default=BENCH_GRID.start_hz,
                   help="doppler grid start (Hz)")
    p.add_argument("--freq-stop", type=float, default=BENCH_GRID.stop_hz,
                   help="doppler grid stop, exclusive (Hz)")
    p.add_argument("--freq-step", type=float, default=BENCH_GRID.step_hz,
                   help="doppler grid step (Hz)")
    p.add_argument("--fs", type=float, default=DEFAULT_SAMPLE_RATE,
                   help="sample rate (Hz)")


def _grid(args) -> FreqGrid:
    return FreqGrid(args.freq_start, args.freq_stop, args.freq_step)


def cmd_generate(args) -> int:
    from caf_cookoff_tpu_torch.utils.generate import synthesize_fixtures

    for needle, haystack in synthesize_fixtures(args.out, count=args.count,
                                                seed=args.seed):
        print(f"{needle}  +  {haystack}")
    return 0


def cmd_run(args) -> int:
    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle = load_c64(args.needle)
    haystack = load_c64(args.haystack, count=len(needle))
    freqs = _grid(args).frequencies(np.float32)
    freq, lag, value = caf_peak(needle, haystack, freqs, args.fs,
                                backend=args.backend, device=args.device)
    print(f"Frequency offset: {freq:.3f} Hz")
    print(f"Time offset: {lag} samples ({lag / args.fs * 1e3:.4f} ms)")
    print(f"Peak value: {value:.6g}")
    return 0


def cmd_bench(args) -> int:
    from caf_cookoff_tpu_torch.utils.bench import (apply_shift_microbench,
                                                   run_benchmarks)

    results = run_benchmarks(
        grid=_grid(args), sample_rate=args.fs, rounds=args.rounds,
        backends=args.backends.split(","), data_dir=args.data,
        device=args.device)
    micro = (apply_shift_microbench(device=args.device) if args.micro
             else None)
    if args.json:
        print(json.dumps(results + ([micro] if micro else []), indent=2))
        return 0
    if results:
        print(f"{results[0]['device']} ({results[0]['power_limit']})")
    print(f"{'strategy':<26}{'ms/surface':>11}{'surfaces/s':>11}"
          f"{'TFLOP/s':>9}{'MFU%':>7}  golden")
    for row in results:
        if row.get("error"):
            print(f"{row['strategy']:<26}{'—':>11}  {row['error']}")
        else:
            tf = f"{row['tflops']:>9.2f}" if "tflops" in row else f"{'—':>9}"
            mfu = (f"{row['mfu_pct']:>7.1f}" if "mfu_pct" in row
                   else f"{'—':>7}")
            print(f"{row['strategy']:<26}{row['ms']:>11.3f}"
                  f"{1e3 / row['ms']:>11.1f}{tf}{mfu}  "
                  f"{row.get('golden', '—')}")
    if micro:
        print(f"\napply_shift ({micro['samples']} samp): "
              f"{micro['us_per_call']} us  "
              f"(reference best {micro['reference_best_us']} us)")
    return 0


def cmd_selftest(args) -> int:
    """The ten golden fixtures through one backend: the injected (freq,
    lag) comes from each haystack's file name; an answer is exact when
    the lag equals it and the frequency lies within one grid step of
    it.  Exit 0 only if all ten are exact."""
    import contextlib
    import tempfile

    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

    with contextlib.ExitStack() as stack:
        data_dir = args.data or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="caf_selftest_"))
        pairs = ensure_fixtures(data_dir)
        grid = FreqGrid(-100.0, 100.0, 0.25)
        freqs = grid.frequencies(np.float32)
        failures = 0
        for n_path, h_path in pairs:
            truth = parse_ground_truth(h_path)
            needle = load_c64(n_path)
            hay = load_c64(h_path, count=len(needle))
            freq, lag, _ = caf_peak(needle, hay, freqs, DEFAULT_SAMPLE_RATE,
                                    backend=args.backend, device=args.device)
            if (lag == truth.lag_samples
                    and abs(freq - truth.freq_hz) <= grid.step_hz):
                print(f"chirp_{truth.index}: ok ({freq:+.2f} Hz, lag {lag})")
            else:
                failures += 1
                print(f"chirp_{truth.index}: FAIL got ({freq:+.2f}, {lag}) "
                      f"want ({truth.freq_hz:+.2f} +-{grid.step_hz}, "
                      f"{truth.lag_samples})")
        total = len(pairs)
        print(f"{total - failures}/{total} golden fixtures exact "
              f"(backend={args.backend})")
        return 1 if failures else 0


def cmd_info(args) -> int:
    import torch

    from caf_cookoff_tpu_torch.config import resolve_backend
    from caf_cookoff_tpu_torch.ops import _build
    from caf_cookoff_tpu_torch.utils.bench import nvidia_smi_card

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count:
        names = sorted({torch.cuda.get_device_name(i) for i in range(count)})
        print(f"cards: {count} x {', '.join(names)}")
    else:
        print("cards: none (torch sees no CUDA card; compute verbs need "
              "--device cpu)")
    print(f"nvidia-smi: {nvidia_smi_card() or 'not available'}")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    print(f"nvcc: {nvcc or 'not found'}")
    lib = _build.library_path()
    print(f"kernel library: {lib if lib.exists() else 'not built'} "
          f"(built at first kernel launch)")
    print(f"resolved FFT backend: {resolve_backend('auto')} (torch.fft: "
          f"{'cuFFT' if count else 'pocketfft'})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m caf_cookoff_tpu_torch",
        description="cross-ambiguity-function engine (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="synthesize the chirp fixtures")
    g.add_argument("--out", default="data", help="output directory")
    g.add_argument("--count", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="CAF one (needle, haystack) .c64 pair "
                       "(haystack truncated to the needle length)")
    r.add_argument("needle", help=".c64 needle (signal of interest)")
    r.add_argument("haystack", help=".c64 haystack (capture)")
    _add_grid_args(r)
    r.add_argument("--backend", choices=BACKENDS, default="auto",
                   help=_BACKEND_HELP)
    r.add_argument("--device", default=None, help=_DEVICE_HELP)
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser("bench", help="README-style strategy table, timed "
                       "on the CUDA card")
    _add_grid_args(b)
    b.add_argument("--rounds", type=int, default=3,
                   help="timing rounds (reference uses 3, caf.py:137)")
    b.add_argument("--backends", default="xla,matmul,stein",
                   help="comma list, or 'all' for every backend "
                   "(xla, matmul[-highest|-bf16], pallas[-bf16|-refine], "
                   "stein[-raw])")
    b.add_argument("--data", default="data")
    b.add_argument("--json", action="store_true")
    b.add_argument("--micro", action="store_true",
                   help="include the apply_shift microbench")
    b.add_argument("--device", default="cuda",
                   help="CUDA device to time (a non-CUDA device fails)")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("selftest", help="run the 10 golden fixtures; "
                        "exit 0 iff all exact")
    st.add_argument("--backend", choices=BACKENDS, default="auto",
                    help=_BACKEND_HELP)
    st.add_argument("--data", default=None,
                    help="fixture directory (default: a temp dir)")
    st.add_argument("--device", default=None, help=_DEVICE_HELP)
    st.set_defaults(fn=cmd_selftest)

    i = sub.add_parser("info", help="torch, card, nvcc, kernel library and "
                       "backend resolution (no tunnel probes: the card is "
                       "local; the native libcafio line waits for "
                       "utils/native.py)")
    i.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
