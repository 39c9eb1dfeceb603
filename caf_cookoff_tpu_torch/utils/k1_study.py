"""Two studies of K1 (``csrc/fused_stein.cu``) on a CUDA card, each run
on copies of the package in a temporary directory, from the root of a
checkout (they reuse ``chip_smoke.py``'s recipes and checks):

    python -m caf_cookoff_tpu_torch.utils.k1_study mutants [NAME ...]
    python -m caf_cookoff_tpu_torch.utils.k1_study split [NAME=FILE.cu ...]

``mutants``: each mutant is the package with one edit to
``fused_stein.cu``; ``chip_smoke.py`` and the K1 card tests run on it
and must fail (the first failed check is printed, logs go to
``chiprun_out/``).  ``split``: K1's device time (``torch.profiler``) at
configs 2 and 4 and rate3's shapes as it is, with stage B skipped and
with stage A skipped, and for each extra ``NAME=FILE.cu`` source, which
is also held to ``rank_bound_check`` at configs 2 and 4.
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
_RECOMPUTE = """    tile_product(ws1, ws2, num_bins, b2, kb8, gs, lay.g_stride, acc);
    const int k = kb8 + g;
    const int lo = k < k_hi"""
_FMA_LOOP = """    {
      const int kk = kb8 + g;
      for (int nt = 0; nt < kNTiles; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      for (int r = 0; r < b2; ++r) {
        const float w1 = kk < num_bins
            ? __bfloat162float(ws1[static_cast<size_t>(kk) * b2 + r]) : 0.f;
        const float w2 = kk < num_bins
            ? __bfloat162float(ws2[static_cast<size_t>(kk) * b2 + r]) : 0.f;
        for (int nt = 0; nt < kNTiles; ++nt)
          for (int q = 0; q < 2; ++q) {
            const float gv = __bfloat162float(
                gs[(nt * 8 + 2 * t + q) * lay.g_stride + r]);
            acc[nt][q] = fmaf(w1, gv, acc[nt][q]);
            acc[nt][2 + q] = fmaf(w2, gv, acc[nt][2 + q]);
          }
      }
    }
    const int k = kb8 + g;
    const int lo = k < k_hi"""

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
}

_TILE_A = """  build_g_tile(lmat, h, p, num_blocks, sup, h_len, windows, share_h, tau0,
               lay, gs, bufs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;"""
SPLITS = {
    "full": None,
    "stage_a_only": (_TILE_A, _TILE_A + "\n  if (num_bins > 0) return;"),
    "stage_b_only": (_TILE_A, _TILE_A.replace(
        "  build_g_tile(lmat, h, p, num_blocks, sup, h_len, windows, "
        "share_h, tau0,\n               lay, gs, bufs);", "  (void)bufs;")),
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
    if not argv or argv[0] not in ("mutants", "split"):
        print(__doc__)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").exists():
        raise SystemExit("k1_study: run it from the root of a checkout")
    (mutants if argv[0] == "mutants" else split)(root, argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
