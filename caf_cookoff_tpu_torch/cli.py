"""Command-line interface (``generate`` and ``run``).

  python -m caf_cookoff_tpu_torch generate --out DIR
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 HAYSTACK.c64 [--backend stein]

``run`` truncates the haystack to the needle length, as the reference
does, and prints the reference's two result lines.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from caf_cookoff_tpu_torch.config import (BACKENDS, BENCH_GRID,
                                          DEFAULT_SAMPLE_RATE, FreqGrid)


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
    freqs = FreqGrid(args.freq_start, args.freq_stop,
                     args.freq_step).frequencies(np.float32)
    freq, lag, value = caf_peak(needle, haystack, freqs, args.fs,
                                backend=args.backend, device=args.device)
    print(f"Frequency offset: {freq:.3f} Hz")
    print(f"Time offset: {lag} samples ({lag / args.fs * 1e3:.4f} ms)")
    print(f"Peak value: {value:.6g}")
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
    r.add_argument("--freq-start", type=float, default=BENCH_GRID.start_hz,
                   help="doppler grid start (Hz)")
    r.add_argument("--freq-stop", type=float, default=BENCH_GRID.stop_hz,
                   help="doppler grid stop, exclusive (Hz)")
    r.add_argument("--freq-step", type=float, default=BENCH_GRID.step_hz,
                   help="doppler grid step (Hz)")
    r.add_argument("--fs", type=float, default=DEFAULT_SAMPLE_RATE,
                   help="sample rate (Hz)")
    r.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="auto/xla/matmul*: filterbank on torch.fft; "
                   "stein: segmented engine with the fused rank kernel "
                   "and exact re-score")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda if available, else "
                   "cpu)")
    r.set_defaults(fn=cmd_run)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
