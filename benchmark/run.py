"""Run one cell of the benchmark once, on the card of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up loads the port and its kernel
library (nvcc builds it into ``build/torch_kernels/`` on a checkout's
first run), draws the cell's pool of distinct inputs from ``--seed``,
puts them where the cell's entry takes them and warms every search of
the pool up (each CUDA graph is captured there).  The window then runs
searches back to back for ``--seconds`` (``--trace 1``: at most
``TRACE_SECONDS``, inside ``torch.profiler``).  Once it has closed the
plain reference judges every answer (``compare.py``).

Standard output: a line of set-up's parts and other readings, then, as
its last line, the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and with a trace ``breakdown``, and last
``checks``: each number compared with its limit, which are also the
last lines of standard error.  Without a card, with fewer cards than
the cell asks for, without the port in this checkout, or with JAX or
the JAX package loaded in this process, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "caf_cookoff_tpu")
TRACE_SECONDS = 2.0      # the traced stretch of a --trace 1 window
WARMUP_PASSES = 3        # searches of each pool item before the window
EVENTS = 64              # CUDA events the window's clock reuses


@dataclass
class RunData:
    """What the metrics' readers read."""
    cell: object
    setup_s: float
    window_s: float
    searches: int
    durations: List[Tuple[str, float]]
    trace: Optional[object] = None
    bound: Optional[Dict] = None


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library that the port loads pulls JAX in."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float = T0,
             parts: Optional[Dict] = None, config: Optional[Dict] = None,
             workload: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """One run of cell ``name``: ``(result, info)``.  ``config`` and
    ``workload`` update the cell's files' keys (the CPU tests run cells
    at small sizes, on ``device="cpu"``)."""
    import torch

    from benchmark import cell as cells
    from benchmark import compare, roofline, spec
    from benchmark import trace as traces
    from benchmark import window
    from caf_cookoff_tpu_torch.ops import _build, _graph

    parts = dict(parts or {})
    bench = spec.load_benchmark()
    row = spec.workload_row(bench, name)
    cell = cells.load(name, device, config, workload)
    entry = spec.load_module("entries", cell.workload["entry"])
    reference = spec.load_module("reference", cell.workload["entry"])
    cuda = torch.device(device).type == "cuda"

    def part(key, t):
        _sync(device)
        now = time.perf_counter()
        parts[key] = now - t
        return now

    t = time.perf_counter()
    if cuda:
        _build.load_library()
    t = part("library", t)
    pool = cells.make_pool(cell, seed)
    t = part("inputs", t)
    items = [entry.prepare(cell, it) for it in pool]
    t = part("upload", t)
    captures = _graph.CAPTURES
    scratch = window.Clock(device)
    for _ in range(WARMUP_PASSES):
        for it in items:
            with scratch.step("search"):
                entry.search(cell, it, scratch)
    t = part("warmup", t)
    captured_in_setup = _graph.CAPTURES - captures
    window_len = min(seconds, TRACE_SECONDS) if trace else seconds
    clock = window.Clock(device, trace)
    clock.reserve(EVENTS)
    gc.freeze()
    part("events", t)
    setup_s = time.perf_counter() - t0

    captures = _graph.CAPTURES
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            answers, window_s = window.run(entry, cell, items, window_len,
                                           clock)
            _sync(device)
    else:
        answers, window_s = window.run(entry, cell, items, window_len, clock)
    captured_in_window = _graph.CAPTURES - captures
    durations = clock.durations_ms()
    gc.unfreeze()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t = time.perf_counter()
    if trace:
        tr = traces.from_profiler(prof)
        del prof
    trace_read_s = time.perf_counter() - t
    del items, clock, scratch
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    limits = cell.workload["limits"]
    verdict = compare.judge(cell, entry, reference, pool, answers, limits)
    reference_s = time.perf_counter() - t

    lo, hi, _ = reference.lag_range(cell)
    bound = roofline.search_bound(
        int(cell.config["needle_len"]), pool[0]["hays"].shape[-1],
        cell.freqs, cell.fs, hi - lo, cell.pairs)
    run = RunData(cell, setup_s, window_s, len(answers), durations, tr,
                  bound)
    metrics = {}
    for m in spec.metrics_for(bench, name, trace):
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(row["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": verdict["failed"] == 0 and len(answers) > 0,
              "attempted": len(answers), "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    # An answer off the grid or the lags reads an infinite gap: the
    # line carries the largest float, which JSON can hold.
    result["checks"] = {k: {"value": min(v, sys.float_info.max),
                            "limit": limits[k]}
                        for k, v in verdict["numbers"].items()}
    info = {"cell": name, "seed": seed, "setup_parts_s": parts,
            "captures_in_setup": captured_in_setup,
            "captures_in_window": captured_in_window,
            "window_s": window_s, "searches": len(answers),
            "memory_peak_bytes": memory_peak,
            "reference_s": reference_s, "trace_read_s": trace_read_s,
            "readings": verdict["readings"],
            "roofline": bound,
            "card": power_limit() if cuda else None}
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m benchmark.run",
        description="Run one cell of the benchmark once on this machine's "
                    "card and print its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    parts: Dict[str, float] = {}
    t = time.perf_counter()
    import torch

    from benchmark import spec

    chips = int(spec.workload_row(spec.load_benchmark(),
                                  args.workload)["chips"])
    parts["import_torch"] = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    parts["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        import caf_cookoff_tpu_torch
    except ImportError as exc:
        print(f"benchmark: the port does not import: {exc}", file=sys.stderr)
        return 2
    if not Path(caf_cookoff_tpu_torch.__file__).resolve().is_relative_to(
            ROOT):
        print(f"benchmark: the port at {caf_cookoff_tpu_torch.__file__} is "
              f"not this checkout's", file=sys.stderr)
        return 2
    parts["import_port"] = time.perf_counter() - t
    torch.set_num_threads(1)
    result, info = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), parts=parts)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(info))
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
