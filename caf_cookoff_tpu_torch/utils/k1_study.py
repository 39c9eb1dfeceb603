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
``chiprun_out/``).  M1-M5 edit the tile launch's device functions (M1
stage A, which the pipelined launch shares), M6-M8 the pipelined
launch.  ``split``: K1's device time (``torch.profiler``) at configs 2,
3 and 4 and rate3's shapes as it is, with stage B skipped and with
stage A skipped (in both launches: each variant's edits apply where
their site is in the source, so it runs on a checkout that lacks the
pipelined launch too), and for each extra ``NAME=FILE.cu`` source,
which is also held to ``rank_bound_check`` at configs 2, 3 and 4.
``compare``:
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
_FULL_WAIT = ("      mbar_wait(full + buf, static_cast<unsigned>((j / kTeams) "
              "& 1));")
_WGMMA = """          wgmma_n(acc, wgmma_desc(waddr + s * 2 * kWLbo, kWLbo, kWSbo),
                  wgmma_desc(gaddr + s * 2 * kGLbo, kGLbo, lay.g_sbo), s);"""
_PIPE_TIE = "      if (v > best) {  // strict: a tie keeps the lower lag"

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
    # pipelined: the warpgroup waits on the wrong phase of its G buffer's
    # full barrier, so it reads the buffer while stage A still writes it
    "M6_pipe_buffer_parity": (_FULL_WAIT, _FULL_WAIT.replace(
        "(j / kTeams) & 1", "((j / kTeams) & 1) ^ 1")),
    # pipelined: the accumulators rounded to bf16 after every k step
    "M7_pipe_bf16_accumulator": (_WGMMA, _WGMMA + """
          wgmma_commit();
          wgmma_wait_all();
          for (int q = 0; q < kLagTile / 2; ++q)
            acc[q] = __bfloat162float(__float2bfloat16_rn(acc[q]));
          wgmma_fence();"""),
    # pipelined: a tie inside a thread's lags goes to the higher lag
    "M8_pipe_tie_to_higher_lag": (_PIPE_TIE, _PIPE_TIE.replace(
        "v > best", "v >= best")),
}

_TILE_A = """  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, h_len,
                       windows, share_h, tau0, lay, gs, bufs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;"""
_PIPE_B = """        wgmma_fence();
        for (int s = 0; s < ksteps; ++s) {"""
_PIPE_EPILOGUE = "        if (whole)\n          scan_lags<false>"
_PIPE_A = """      stage_a<false, kTeamWarps>(
          lmat, h, w.p, num_blocks, 0, num_blocks, sup, h_len, windows,"""
# Each variant: (site, replacement) edits, applied where the site is.
SPLITS = {
    "full": None,
    "stage_a_only": [
        (_TILE_A, _TILE_A + "\n  if (num_bins > 0) return;"),
        # the warpgroup keeps its waits and hand-backs, runs no product
        (_PIPE_B, """        if (num_bins < 0) wgmma_fence();
        for (int s = 0; s < ksteps && num_bins < 0; ++s) {"""),
        (_PIPE_EPILOGUE, "        if (num_bins < 0)\n          ;\n"
         "        else if (whole)\n          scan_lags<false>")],
    "stage_b_only": [
        (_TILE_A, _TILE_A.replace(
            "  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, "
            "h_len,\n                       windows, share_h, tau0, lay, gs, "
            "bufs);",
            "  (void)bufs;")),
        # the teams keep their hand-offs, build no G
        (_PIPE_A, """      if (use > 0) mbar_wait(empty + team, (use - 1) & 1);
      if (num_bins < 0) stage_a<false, kTeamWarps>(
          lmat, h, w.p, num_blocks, 0, num_blocks, sup, h_len, windows,""")],
}

_SPLIT_CODE = """
import sys
sys.path.insert(0, {dst!r})
import torch
import chip_smoke as cs
from caf_cookoff_tpu_torch.ops import fused_stein as fs
torch.backends.cuda.matmul.allow_tf32 = False
cfgs = cs.config_inputs()
shapes = {{n: cs.config_operands(cfgs[n])
          for n in ("config2", "config3", "config4")}}
shapes["rate3"] = cs.rate_operands(cs.rate_inputs()["rate3"])
for n, (ops, b, sup, m, modes, _) in shapes.items():
    before = getattr(fs, "PIPELINED_LAUNCHES", 0)
    ms = cs.device_ms(lambda: fs.fused_stein_rank(*ops, b, sup, m, **modes),
                      10)
    path = ("pipelined" if getattr(fs, "PIPELINED_LAUNCHES", 0) > before
            else "tile")
    chk = ""
    if {check} and n != "rate3":
        r = fs.rank_bound_check(fs.fused_stein_rank(*ops, b, sup, m, **modes),
                                *ops, b, sup, m, **modes)
        chk = f" bound ok={{r['ok']}} ratio={{r['ratio']:.3e}}"
    print(f"{name:14s} {{n}}: device {{ms:.4f}} ms ({{path}} launch){{chk}}",
          flush=True)
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
sin = cs.stream_inputs()
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
    edits = [edit] if isinstance(edit, tuple) else edit
    found = [e for e in edits if src.count(e[0]) == 1]
    if not found or any(src.count(e[0]) > 1 for e in edits):
        raise SystemExit(f"k1_study: edit site not found once in {CU}")
    for old, new in found:
        src = src.replace(old, new)
    (dst / CU).write_text(src)


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
