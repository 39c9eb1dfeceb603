"""Studies of K2/K3, the fused filterbank kernels (``csrc/caf_filterbank.cu``),
on a CUDA card, from the root of a checkout:

    python -m caf_cookoff_tpu_torch.utils.fb_study times [--label L]
        [--data DIR] [--out DIR]
    python -m caf_cookoff_tpu_torch.utils.fb_study compare OTHER_CHECKOUT
    python -m caf_cookoff_tpu_torch.utils.fb_study mutants [NAME ...]

``times``: occupancy (blocks per SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, cluster size, waves)
at K = 400 and K = 8, M = 8192; CUDA-event medians of K2 and K3 launched
alone on prepared operands (400 x 8192, and K2 at the refine tier's
K = 8), ten back to back from Python and as device time (replays of a
CUDA graph of ten launches; with this checkout's kernel also at each
cluster size C = 1, 2, 4, 8), of the wrappers ``pallas_peak_rows`` /
``pallas_surface`` at 400 x 8192 and of
``caf_peak(backend="pallas-refine")`` on chirp_0; the kernels each call
launches, counted by ``torch.profiler``.  It reads
only names that every version of ``ops/pallas_caf`` has, so it also runs
on older checkouts (a kernel without its own occupancy entry point is
probed by a small library that includes its source, built under
``$TMPDIR``).  Fixtures come from ``--data`` (default ``data/``, made if
missing); one JSON line goes to ``<out>/fb_times_<label>.json`` (default
``chiprun_out/``).

``compare``: ``times`` in this checkout and in OTHER_CHECKOUT, in turns:
other, this, this, other.  A copy of this file under this checkout's
``build/`` runs from each checkout's root, with this checkout's fixtures
and output directory; nothing is written into OTHER_CHECKOUT but what its
own package builds at first use (its ``build/torch_kernels/``).

``mutants``: each mutant is a copy of the package with one edit to the
row transform K2/K3 share with K5 (``csrc/fft_rows.cuh``);
``chip_smoke.py`` and the filterbank card tests run on it and must fail
(logs go to ``chiprun_out/``).
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CU = "caf_cookoff_tpu_torch/csrc/caf_filterbank.cu"
ROWS = "caf_cookoff_tpu_torch/csrc/fft_rows.cuh"   # the mutants' edit sites
FS = 48_000.0

# A probe for a kernel source without caf_filterbank_occupancy: its two
# kernels took 512 threads and M * 8 bytes of dynamic shared memory.
_PROBE = """#include "{src}"
extern "C" int probe_occupancy(int surface, int m, int* blocks) {{
  const size_t smem = static_cast<size_t>(m) * sizeof(float2);
  if (surface) {{
    prepare(caf_surface_kernel, smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, caf_surface_kernel, kThreads, smem);
  }}
  prepare(caf_peak_rows_kernel, smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, caf_peak_rows_kernel, kThreads, smem);
}}
"""


def _median_ms(fn, runs: int, warmup: int = 5) -> float:
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


def _graph_ms(fn, burst: int = 10, rounds: int = 20) -> float:
    """Device ms of one call of ``fn``: replays of a CUDA graph of
    ``burst`` calls, so no host time sits between the launches."""
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
    return _median_ms(graph.replay, rounds, 3) / burst


def _kernels_per_call(fn, runs: int = 5) -> float:
    """Device kernels (not memcpys or memsets) a call of ``fn`` launches,
    from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.lower().startswith(("memcpy", "memset")))
    return n / runs


def _occupancy(root: Path, pc, k: int, m: int, c_set=None):
    """(blocks per SM, cluster size, waves) of K2 and K3 at (k, m)."""
    import torch

    from caf_cookoff_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.load_library()
    out = {}
    for surface in (0, 1):
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(-1)
        if hasattr(lib, "caf_filterbank_occupancy"):
            c = c_set or pc.cluster_size(m)
            rc = lib.caf_filterbank_occupancy(surface, m, c,
                                              ctypes.byref(blocks),
                                              ctypes.byref(clusters))
        else:
            c = 1
            rc = _probe(root).probe_occupancy(surface, m, ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"occupancy query failed ({rc})")
        slots = blocks.value * sms
        out["k3" if surface else "k2"] = {
            "blocks_per_sm": blocks.value, "cluster": c, "blocks": k * c,
            "max_active_clusters": clusters.value,
            "waves": math.ceil(k * c / slots) if slots else None,
            "last_wave_fill": ((k * c - 1) % slots + 1) / slots
            if slots else None}
    return out


def _probe(root: Path):
    from caf_cookoff_tpu_torch.ops import _build

    out = Path(tempfile.mkdtemp(prefix="fb_probe"))
    src = out / "probe.cu"
    src.write_text(_PROBE.format(src=(root / CU).resolve()))
    lib = out / "libprobe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True)
    probe = ctypes.CDLL(str(lib))
    probe.probe_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    probe.probe_occupancy.restype = ctypes.c_int
    return probe


def times(root: Path, label: str, data: Path, logs: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import caf_cookoff_tpu_torch
    from caf_cookoff_tpu_torch import BENCH_GRID, caf_peak
    from caf_cookoff_tpu_torch.ops import pallas_caf as pc
    from caf_cookoff_tpu_torch.utils.bench import nvidia_smi_card
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64

    if Path(caf_cookoff_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit("fb_study: the package is not this checkout's")
    if not torch.cuda.is_available():
        raise SystemExit("fb_study: torch sees no CUDA card")
    card = nvidia_smi_card()
    pairs = ensure_fixtures(data)
    n0 = load_c64(pairs[0][0])
    h0 = load_c64(pairs[0][1], count=len(n0))
    needle = torch.from_numpy(n0).cuda()
    hay = torch.from_numpy(h0).cuda()
    bench = BENCH_GRID.frequencies(np.float32)
    freqs = torch.from_numpy(bench).cuda()
    m = 8192
    # The refine tier's second launch: the 8 bins nearest chirp_0's peak.
    near = torch.argsort((freqs - 69.25).abs())[:8].sort().values
    f8 = freqs[near]
    occ = {"K400": _occupancy(root, pc, 400, m), "K8": _occupancy(root, pc, 8,
                                                                  m)}
    kops = pc._kernel_operands(needle, hay, freqs, FS, m)
    kops8 = pc._kernel_operands(needle, hay, f8, FS, m)
    t = {
        "k2_alone_400": _median_ms(lambda: [pc._run_kernel(
            "peak", *kops, m) for _ in range(10)], 20) / 10,
        "k3_alone_400": _median_ms(lambda: [pc._run_kernel(
            "surface", *kops, m) for _ in range(10)], 20) / 10,
        "k2_alone_8": _median_ms(lambda: [pc._run_kernel(
            "peak", *kops8, m) for _ in range(10)], 20) / 10,
        "k2_graph_400": _graph_ms(lambda: pc._run_kernel("peak", *kops, m)),
        "k3_graph_400": _graph_ms(lambda: pc._run_kernel("surface", *kops,
                                                         m)),
        "k2_graph_8": _graph_ms(lambda: pc._run_kernel("peak", *kops8, m)),
        "k2_wrapper_400": _median_ms(lambda: pc.pallas_peak_rows(
            needle, hay, freqs, FS, m), 50),
        "k3_wrapper_400": _median_ms(lambda: pc.pallas_surface(
            needle, hay, freqs, FS, m), 50),
        "pallas_refine_call": _median_ms(lambda: caf_peak(
            n0, h0, bench, FS, backend="pallas-refine", device="cuda"), 50),
    }
    if hasattr(pc, "cluster_size"):
        # The cluster size at 400 x 8192, each C held to K2's plain values:
        # H gathered for C blocks a bin, the wrapper's operands otherwise.
        plain = pc.caf_peak_rows_plain(needle, hay, freqs, FS, m)[0]
        spec = pc._haystack_spectrum(hay, m)
        for c in (1, 2, 4, 8):
            ops_c = kops._replace(h=pc._h_kernel(spec, m, c), c=c)
            ops8 = kops8._replace(h=ops_c.h, c=c)
            got = pc._run_kernel("peak", *ops_c, m)[0]
            rel = ((got - plain).abs() / plain).max().item()
            t[f"k2_graph_400_c{c}"] = _graph_ms(lambda: pc._run_kernel(
                "peak", *ops_c, m))
            t[f"k3_graph_400_c{c}"] = _graph_ms(lambda: pc._run_kernel(
                "surface", *ops_c, m))
            occ[f"K400_c{c}"] = _occupancy(root, pc, 400, m, c)
            t[f"k2_graph_8_c{c}"] = _graph_ms(lambda: pc._run_kernel(
                "peak", *ops8, m))
            print(f"[fb {label}] K2 at C={c}: max rel err {rel:.3e}")
    kernels = {
        "k2_wrapper_400": _kernels_per_call(lambda: pc.pallas_peak_rows(
            needle, hay, freqs, FS, m)),
        "k3_wrapper_400": _kernels_per_call(lambda: pc.pallas_surface(
            needle, hay, freqs, FS, m)),
        "pallas_refine_call": _kernels_per_call(lambda: caf_peak(
            n0, h0, bench, FS, backend="pallas-refine", device="cuda")),
    }
    rec = {"label": label, "root": str(root), "card": card,
           "occupancy": occ, "ms": t, "kernels_per_call": kernels}
    for key, ms in t.items():
        print(f"[fb {label}] {key}: {ms:.4f} ms  [{card}]")
    for key, n in kernels.items():
        print(f"[fb {label}] {key}: {n:g} device kernels a call "
              f"(torch.profiler)")
    for shape, per in occ.items():
        for kern, o in per.items():
            print(f"[fb {label}] {kern} {shape} M=8192: {o}")
    logs.mkdir(parents=True, exist_ok=True)
    (logs / f"fb_times_{label}.json").write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return rec


def compare(root: Path, other: Path) -> None:
    other = other.resolve()
    copy = root / "build" / "fb_study" / Path(__file__).name
    copy.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(__file__), copy)
    for which in (other, root, root, other):
        label = "this" if which == root else "other"
        p = subprocess.run(
            [sys.executable, str(copy), "times", "--label", label, "--data",
             str(root / "data"), "--out", str(root / "chiprun_out")],
            cwd=which, capture_output=True, text=True, timeout=900)
        print("\n".join(ln for ln in p.stdout.splitlines()
                        if ln.startswith("[fb")), flush=True)
        if p.returncode != 0:
            print(f"fb_study times in {which} failed ({p.returncode}):\n"
                  f"{p.stdout[-2000:]}{p.stderr[-2000:]}", flush=True)


MUTANTS = {
    # the first forward pass's twiddles conjugated
    "M1_conjugated_twiddle": (
        "    twiddle<16, false>(v, tw, 1 << LOG_S0, j);",
        "    twiddle<16, true>(v, tw, 1 << LOG_S0, j);"),
    # H read as the radix-2 kernel stored it: bit-reversed positions
    "M2_h_bit_reversed": (
        "v[i] = cmul_conj(__ldg(&hb[(u * S::RL + i) * S::T + t]), v[i]);",
        "v[i] = cmul_conj(__ldg(&hb[__brev(base + i) >> (32 - LOG_L)]), "
        "v[i]);"),
    # the cross-block merge keeps the later block on equal values
    "M3_merge_ties_high": (
        """      take(*cluster.map_shared_rank(&s_best, b),
           *cluster.map_shared_rank(&s_arg, b), best, arg);""",
        """      if (*cluster.map_shared_rank(&s_best, b) >= best) {
        best = *cluster.map_shared_rank(&s_best, b);
        arg = *cluster.map_shared_rank(&s_arg, b);
      }"""),
    # the phasor on the fast-math intrinsic
    "M4_fast_sincos": (
        "  sincosf(rate * static_cast<float>(n), &sn, &cs);",
        "  __sincosf(rate * static_cast<float>(n), &sn, &cs);"),
}


def _copy(root: Path, dst: Path, edit) -> None:
    shutil.copytree(root / "caf_cookoff_tpu_torch",
                    dst / "caf_cookoff_tpu_torch")
    shutil.copy(root / "chip_smoke.py", dst)
    (dst / "tests").mkdir()
    shutil.copy(root / "tests" / "test_torch_cuda.py", dst / "tests")
    if (root / "data").exists():
        shutil.copytree(root / "data", dst / "data")
    src = (dst / ROWS).read_text()
    if src.count(edit[0]) != 1:
        raise SystemExit(f"fb_study: edit site not found once in {ROWS}")
    (dst / ROWS).write_text(src.replace(*edit))


def _run(cmd, cwd, limit):
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                           timeout=limit)
        return p.returncode, p.stdout + p.stderr, time.time() - t0
    except subprocess.TimeoutExpired as exc:
        out = exc.stdout or ""
        return 124, out if isinstance(out, str) else out.decode(), limit


def mutants(root: Path, names) -> None:
    logs = root / "chiprun_out"
    logs.mkdir(exist_ok=True)
    for name in names or MUTANTS:
        with tempfile.TemporaryDirectory(prefix=name) as tmp:
            dst = Path(tmp)
            _copy(root, dst, MUTANTS[name])
            rc, out, sec = _run([sys.executable, "chip_smoke.py"], dst, 600)
            (logs / f"mutant_{name}.log").write_text(out)
            failed = [ln for ln in out.splitlines() if "FAILED" in ln]
            print(f"== {name}: chip_smoke rc={rc} in {sec:.0f} s; "
                  f"{failed[-1] if failed else 'no failed check'}")
            for ln in [ln for ln in out.splitlines()
                       if ln.startswith("[kernel] K2")
                       or ln.startswith("[kernel] K3")][:4]:
                print("   ", re.sub(r"\s+", " ", ln)[:300])
            rc, out, sec = _run(
                [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py",
                 "--noconftest", "-m", "cuda", "-q", "-p", "no:cacheprovider",
                 "-k", "filterbank or pallas"], dst, 600)
            (logs / f"mutant_{name}_tests.log").write_text(out)
            tail = [ln for ln in out.splitlines() if ln.strip()][-1:]
            print(f"   card tests rc={rc} in {sec:.0f} s: {tail}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path.cwd().resolve()
    if not (root / "chip_smoke.py").exists():
        raise SystemExit("fb_study: run it from the root of a checkout")
    if argv[:1] == ["times"] and len(argv) % 2:
        opts = dict(zip(argv[1::2], argv[2::2]))
        times(root, opts.get("--label", "this"),
              Path(opts.get("--data", root / "data")),
              Path(opts.get("--out", root / "chiprun_out")))
    elif argv[:1] == ["compare"] and len(argv) == 2:
        compare(root, Path(argv[1]))
    elif argv[:1] == ["mutants"]:
        mutants(root, argv[1:])
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
