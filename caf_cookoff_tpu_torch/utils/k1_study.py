"""Three studies of K1 (``csrc/fused_stein.cu``) on a CUDA card, from
the root of a checkout (they reuse ``chip_smoke.py``'s recipes and
checks; the first two run on copies of the package in a temporary
directory):

    python -m caf_cookoff_tpu_torch.utils.k1_study mutants [NAME ...]
    python -m caf_cookoff_tpu_torch.utils.k1_study split [NAME=FILE.cu ...]
    python -m caf_cookoff_tpu_torch.utils.k1_study compare OTHER_CHECKOUT

``mutants``: each mutant is the package with one edit to
``fused_stein.cu``; ``chip_smoke.py`` and the K1 card tests run on it
and must fail (the first failed check is printed, logs go to
``chiprun_out/``).  ``split``: K1's device time (``torch.profiler``) at
configs 2 and 4 and rate3's shapes as it is, with stage B skipped and
with stage A skipped, and for each extra ``NAME=FILE.cu`` source, which
is also held to ``rank_bound_check`` at configs 2 and 4.  ``compare``:
K1's wrapper ms (CUDA-event medians) and device ms (``torch.profiler``)
at config 1's, config 2's and a stream3 chunk's shapes, and config 1's
whole ``caf_peak(backend="stein")`` call, in OTHER_CHECKOUT and in this
one in turns (other, this, this, other), each in a process of its own
that imports that checkout's package and ``chip_smoke.py`` (each builds
its own kernels under its own ``build/``).
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CU = "caf_cookoff_tpu_torch/csrc/fused_stein.cu"

_STAGE_A = """            acc_top[j] = fmaf(trv[u], a, acc_top[j]);
            acc_top[j] = fmaf(tiv[u], cc, acc_top[j]);
            acc_bot[j] = fmaf(brv[u], a, acc_bot[j]);
            acc_bot[j] = fmaf(biv[u], cc, acc_bot[j]);"""
_MMA = """      mma_bf16(acc[nt], a0, a1, a2, a3,
               *reinterpret_cast<const unsigned*>(gr),
               *reinterpret_cast<const unsigned*>(gr + 8));"""
_KLOOP = "  for (int k0 = 0; k0 < b2p; k0 += 16) {\n    const unsigned a0"
_RECOMPUTE = """        const int k = kb8 + g;
        const int lo = k < k_hi"""
_FMA_LOOP = """        {
          const int kk = kb8 + g;
          for (int nt = 0; nt < kNTiles; ++nt)
            acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
          for (int r = 0; r < b2; ++r) {
            const float w1v = kk < num_bins
                ? __bfloat162float(w1[static_cast<size_t>(kk) * sh.ld + r])
                : 0.f;
            const float w2v = kk < num_bins
                ? __bfloat162float(w2[static_cast<size_t>(kk) * sh.ld + r])
                : 0.f;
            for (int nt = 0; nt < kNTiles; ++nt)
              for (int q = 0; q < 2; ++q) {
                const float gv = __bfloat162float(
                    gs[(nt * 8 + 2 * t + q) * lay.g_stride + r]);
                acc[nt][q] = fmaf(w1v, gv, acc[nt][q]);
                acc[nt][2 + q] = fmaf(w2v, gv, acc[nt][2 + q]);
              }
          }
        }
""" + _RECOMPUTE
_CLOSE = """  for (int r = 1; r < c; ++r) {
    const float4* xr"""

MUTANTS = {
    # stage A: the imaginary plane's tap summed before the real plane's
    "M1_stage_a_planes_swapped": (_STAGE_A, """            acc_top[j] = fmaf(tiv[u], cc, acc_top[j]);
            acc_top[j] = fmaf(trv[u], a, acc_top[j]);
            acc_bot[j] = fmaf(biv[u], cc, acc_bot[j]);
            acc_bot[j] = fmaf(brv[u], a, acc_bot[j]);"""),
    # stage B: the accumulators rounded to bf16 after every k step
    "M2_stage_b_bf16_accumulator": (_MMA, _MMA + """
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[nt][q] = __bfloat162float(__float2bfloat16_rn(acc[nt][q]));"""),
    # stage B: the last 16-row k step skipped where there are two or more
    "M3_k_step_skipped": (_KLOOP, """  for (int k0 = 0; k0 < b2p; k0 += 16) {
    if (k0 > 0 && k0 + 16 == b2p) continue;
    const unsigned a0"""),
    # top-2 recompute: an f32 FMA loop over the rows in order
    "M4_recompute_fma_loop": (_RECOMPUTE, _FMA_LOOP),
    # row split: the last rank's partials left out of every sum
    "M5_split_rank_dropped": (_CLOSE, """  for (int r = 1; r < c - 1; ++r) {
    const float4* xr"""),
}

_TILE_A = """  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, h_len,
                       windows, share_h, tau0, lay, gs, bufs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;"""
SPLITS = {
    "full": None,
    "stage_a_only": (_TILE_A, _TILE_A + "\n  if (num_bins > 0) return;"),
    "stage_b_only": (_TILE_A, _TILE_A.replace(
        "  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, "
        "h_len,\n                       windows, share_h, tau0, lay, gs, "
        "bufs);",
        "  (void)bufs;")),
}

_SPLIT_CODE = """
import sys
sys.path.insert(0, {dst!r})
import torch
import chip_smoke as cs
from caf_cookoff_tpu_torch.ops import fused_stein as fs
torch.backends.cuda.matmul.allow_tf32 = False
cfgs = cs.config_inputs()
shapes = {{n: cs.config_operands(cfgs[n]) for n in ("config2", "config4")}}
shapes["rate3"] = cs.rate_operands(cs.rate_inputs()["rate3"])
for n, (ops, b, sup, m, modes, _) in shapes.items():
    ms = cs.device_ms(lambda: fs.fused_stein_rank(*ops, b, sup, m, **modes),
                      10)
    chk = ""
    if {check} and n != "rate3":
        r = fs.rank_bound_check(fs.fused_stein_rank(*ops, b, sup, m, **modes),
                                *ops, b, sup, m, **modes)
        chk = f" bound ok={{r['ok']}} ratio={{r['ratio']:.3e}}"
    print(f"{name:14s} {{n}}: device {{ms:.4f}} ms{{chk}}", flush=True)
"""


_COMPARE_CODE = """
import sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from caf_cookoff_tpu_torch import BENCH_GRID, caf_peak
from caf_cookoff_tpu_torch.ops import fused_stein as fs
from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
torch.backends.cuda.matmul.allow_tf32 = False
n0, h0 = cs.load_pair(ensure_fixtures(cs.ROOT / "data"), 0)
head = cs.headline_operands(n0, h0, "cuda")
cfgs = cs.config_inputs()
c2 = cs.config_operands(cfgs["config2"])
sin = cs.stream_inputs(cfgs["config3"])
s, _ = cs.stream_through(sin[1][:cs.STREAM_CHUNK], sin[0], sin[3],
                         backend="stein")
ops3, b3, sup3, m3, nv3 = cs.stream_k1_operands(s, sin[1], 0)
shapes = {{
    "config1": lambda: fs.fused_stein_rank(*head[0], *head[1:],
                                           want_idxs=False),
    "config2": lambda: fs.fused_stein_rank(*c2[0], *c2[1:4], want_idxs=False,
                                           **c2[4]),
    "stream3": lambda: fs.fused_stein_rank(*ops3, b3, sup3, m3,
                                           num_valid=nv3),
}}
for n, fn in shapes.items():
    ms = cs.cuda_median_ms(fn, 100 if n == "config1" else 20)
    dev = cs.device_ms(fn)
    print(f"[k1cmp {label}] {{n}} K1 wrapper {{ms:.4f}} ms, device "
          f"{{dev:.4f}} ms", flush=True)
freqs = BENCH_GRID.frequencies(np.float32)
call = cs.cuda_median_ms(lambda: caf_peak(n0, h0, freqs, cs.FS,
                                          backend="stein", device="cuda"), 50)
print(f"[k1cmp {label}] config1 caf_peak stein whole call {{call:.4f}} ms",
      flush=True)
"""


def compare(root: Path, other: Path) -> None:
    other = other.resolve()
    for which in (other, root, root, other):
        label = "this" if which == root else "other"
        rc, out, sec = _run([sys.executable, "-c", _COMPARE_CODE.format(
            label=label)], which, 900)
        print("\n".join(ln for ln in out.splitlines()
                        if ln.startswith("[k1cmp")) if rc == 0 else
              f"k1_study compare in {which} failed ({rc}):\n{out[-2000:]}",
              flush=True)


def _copy(root: Path, dst: Path, edit) -> None:
    shutil.copytree(root / "caf_cookoff_tpu_torch",
                    dst / "caf_cookoff_tpu_torch")
    shutil.copy(root / "chip_smoke.py", dst)
    (dst / "tests").mkdir()
    shutil.copy(root / "tests" / "test_torch_cuda.py", dst / "tests")
    if (root / "data").exists():
        shutil.copytree(root / "data", dst / "data")
    if edit is None:
        return
    if isinstance(edit, Path):
        shutil.copy(edit, dst / CU)
        return
    src = (dst / CU).read_text()
    if src.count(edit[0]) != 1:
        raise SystemExit(f"k1_study: edit site not found once in {CU}")
    (dst / CU).write_text(src.replace(*edit))


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
                       if ln.startswith("[kernel] K1")][-3:]:
                print("   ", re.sub(r"\s+", " ", ln)[:300])
            rc, out, sec = _run(
                [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py",
                 "--noconftest", "-m", "cuda", "-q", "-p", "no:cacheprovider",
                 "-k", "kernel or top2 or rate_rows or bin_splits", "-x"],
                dst, 600)
            (logs / f"mutant_{name}_tests.log").write_text(out)
            tail = [ln for ln in out.splitlines() if ln.strip()][-1:]
            print(f"   card tests rc={rc} in {sec:.0f} s: {tail}", flush=True)


def split(root: Path, extra) -> None:
    variants = dict(SPLITS)
    for spec in extra:
        name, path = spec.split("=", 1)
        variants[name] = Path(path).resolve()
    for name, edit in variants.items():
        with tempfile.TemporaryDirectory(prefix=f"split_{name}") as tmp:
            dst = Path(tmp)
            _copy(root, dst, edit)
            check = name == "full" or isinstance(edit, Path)
            rc, out, _ = _run([sys.executable, "-c", _SPLIT_CODE.format(
                dst=str(dst), name=name, check=check)], dst, 600)
            print(out.strip() if rc == 0 else f"{name}: rc {rc}\n{out[-2000:]}",
                  flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("mutants", "split", "compare") or (
            argv[0] == "compare" and len(argv) != 2):
        print(__doc__)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").exists():
        raise SystemExit("k1_study: run it from the root of a checkout")
    if argv[0] == "compare":
        compare(root, Path(argv[1]))
    else:
        (mutants if argv[0] == "mutants" else split)(root, argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
