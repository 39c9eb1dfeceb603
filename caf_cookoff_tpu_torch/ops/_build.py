"""Build and load the package's CUDA kernels (nvcc + ctypes).

The kernels live in ``caf_cookoff_tpu_torch/csrc/*.cu`` behind a plain
C interface, so nvcc compiles them in seconds (no PyTorch headers): one
nvcc process per source, all started together, then one link into a
shared library, at first use, into ``build/torch_kernels/`` under the
checkout, named by a hash of the sources and flags so an edited source
rebuilds.  Nothing here runs at import time: the CPU tests import every
module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = (PACKAGE_DIR / "csrc" / "fused_stein.cu",
           PACKAGE_DIR / "csrc" / "caf_filterbank.cu",
           PACKAGE_DIR / "csrc" / "stein_rescore.cu",
           PACKAGE_DIR / "csrc" / "roofline_epilogue.cu")
# Included by the sources: part of the library's hash.
HEADERS = (PACKAGE_DIR / "csrc" / "fft_rows.cuh",)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME`` (default /usr/local/cuda) or ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcaf_torch_kernels_{digest.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Each source compiles in its own nvcc process, all at once;
    when it compiles, ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory, spills per kernel) and prints nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                 "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        # Link to a temporary name and rename: concurrent processes never
        # load a half-written library.
        tmp = Path(tmp_dir) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    if verbose:
        print(f"nvcc: {time.perf_counter() - t0:.1f} s ({len(SOURCES)} "
              f"sources in parallel, then one link) -> {out}")
        print("\n".join(log.strip() for log in logs if log.strip()))
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every
    entry point's ``argtypes``/``restype`` declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # ws1, ws2, lmat, h, ws_b, lmat_r, h_r, num_valid (may be null),
    # keys, part_val, part_lag (both null without top-2), vals, lags,
    # vals2, lags2 (both null without top-2); programs, K, B, D, h_len,
    # num_lags, m_pad, windows, share_h, sep, bins_per_split, pipelined
    # blocks (0: the tile launch); stream
    lib.caf_fused_stein_rank.argtypes = [vp] * 15 + [ci] * 12 + [vp]
    lib.caf_fused_stein_rank.restype = ci
    # 2B, D: the pipelined launch's shared memory a block
    lib.caf_fused_stein_pipe_smem.argtypes = [ci, ci]
    lib.caf_fused_stein_pipe_smem.restype = ctypes.c_longlong
    for fn in (lib.caf_fused_stein_lag_tile, lib.caf_fused_stein_bin_pass):
        fn.argtypes = []
        fn.restype = ci
    # 2B, D, out: blocks a lag tile, G rows a block
    lib.caf_fused_stein_plan.argtypes = [ci, ci, vp, vp]
    lib.caf_fused_stein_plan.restype = ctypes.c_longlong
    # 2B, D, out: blocks a SM, clusters the card holds at once
    lib.caf_fused_stein_occupancy.argtypes = [ci, ci, vp, vp]
    lib.caf_fused_stein_occupancy.restype = ci
    # needle, n, h_k, tw, rates, k, m, c, outputs..., stream
    lib.caf_filterbank_peak.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, vp,
                                        vp, vp]
    lib.caf_filterbank_peak.restype = ci
    lib.caf_filterbank_surface.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci,
                                           vp, vp]
    lib.caf_filterbank_surface.restype = ci
    # surface, m, c, blocks per SM (out), clusters (out)
    lib.caf_filterbank_occupancy.argtypes = [ci, ci, ci, vp, vp]
    lib.caf_filterbank_occupancy.restype = ci
    # ranking, k, n_plain, n_sep, freqs, k_grid, cell, two_pi, fs,
    # needles, n, h_k, tw, bounds (may be null), p, m, c, cand, vals, lags,
    # value, freq_idx, lag_idx, stream
    cf = ctypes.c_float
    lib.caf_stein_rescore.argtypes = ([vp, ci, ci, ci, vp, ci, cf, cf, cf,
                                       vp, ci, vp, vp, vp, ci, ci, ci]
                                      + [vp] * 7)
    lib.caf_stein_rescore.restype = ci
    # out, rows, cols, sweeps, seed, stream
    lib.caf_epilogue_roofline.argtypes = [vp, ci, ci, ci, ctypes.c_float, vp]
    lib.caf_epilogue_roofline.restype = ci
    lib.caf_cuda_error_string.argtypes = [ci]
    lib.caf_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
