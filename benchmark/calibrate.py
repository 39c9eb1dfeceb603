"""The readings a cell's limits are set from: the port's and the
control's numbers (``compare.py``: ``peak_gap``, a stream's
``chunk_misses``) and readings (a stream's ``chunk_gap``) on many
seeds, on the card, at the cell's size.

    python3 -m benchmark.calibrate --workload <cell> --seeds S1,S2,... [--seconds 1] [--out F]

For each seed: one run of the cell (``run.run_cell``, a short window at
the cell's own load, every answer judged as a run judges it), which
gives the port's reading; then the control on the same pool: the plain
reference computed in bfloat16 (``reference/caf.py``), put in the
port's place, its answers judged by the same comparison
(``compare.judge``) against the complex128 reference and the cell's
limits, answering as the cell's entry does (a lattice's slots, a rate
cell's rates).  One JSON line a seed.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from types import SimpleNamespace
from typing import Dict


def control(name: str, seed: int, device: str = "cuda", config=None,
            workload=None) -> Dict:
    """The control on cell ``name``'s pool of ``seed``, judged as a run
    is: ``{"numbers": {name: value}, "failed": pool items that
    failed}`` against the cell's limits.  It answers as the cell's entry
    does: each pair's peak, its chunk peaks where the entry has
    ``chunks``, and its lattice where the entry has ``slots``."""
    from benchmark import cell as cells
    from benchmark import compare, spec

    cell = cells.load(name, device, config, workload)
    entry = spec.load_module("entries", cell.workload["entry"])
    reference = spec.load_module("reference", cell.workload["entry"])
    lo = reference.lag_range(cell)[0]
    pool = cells.make_pool(cell, seed)

    def said(peak):
        """A reference's (*key, value) as an answer: (rate, freq, lag,
        value) or (freq, lag, value); an empty slot as value -inf."""
        if peak is None:
            return (*(float(g[0]) for g in cell.grids), lo, -math.inf)
        *axes, lag, value = peak
        return (*(float(g[i]) for g, i in zip(cell.grids, axes)), lag,
                value)

    answers = []
    for k, item in enumerate(pool):
        ctrl = reference.run(cell, item, [()] * cell.pairs, "bfloat16")
        answers.append((k, ([said(r["best"]) for r in ctrl],
                            [[said(s) for s in r["spans"]] for r in ctrl],
                            [[said(s) for s in r["slots"]] for r in ctrl])))
    stand_in = SimpleNamespace(pairs=lambda a: a[0])
    if hasattr(entry, "chunks"):
        stand_in.chunks = lambda a: a[1]
    if hasattr(entry, "slots"):
        stand_in.slots = lambda a: a[2]
    return compare.judge(cell, stand_in, reference, pool, answers,
                         cell.workload["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import run

    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, info = run.run_cell(args.workload, seed, args.seconds, False)
        ctrl = control(args.workload, seed)
        line = {"cell": args.workload, "seed": seed,
                **{f"port_{k}": c["value"]
                   for k, c in result["checks"].items()},
                **{f"port_{k}": v for k, v in info["readings"].items()},
                "searches": result["attempted"],
                "failed": result["failed"],
                **{f"control_{k}": v for k, v in {
                    **ctrl["numbers"], **ctrl["readings"]}.items()},
                "control_failed": ctrl["failed"],
                "seconds": time.perf_counter() - t,
                "card": info["card"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
