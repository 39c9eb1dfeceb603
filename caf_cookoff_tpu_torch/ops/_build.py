"""Build and load the package's CUDA kernels (nvcc + ctypes).

The kernels live in ``caf_cookoff_tpu_torch/csrc/*.cu`` behind a plain
C interface, so nvcc compiles them in seconds (no PyTorch headers); one
nvcc call builds every source into one shared library, at first use,
into ``build/torch_kernels/`` under the checkout, named by a hash of the
sources and flags so an edited source rebuilds.  Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
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
           PACKAGE_DIR / "csrc" / "caf_filterbank.cu")
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

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
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcaf_torch_kernels_{digest.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  When it compiles, ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory, spills per kernel) and prints nvcc's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: concurrent processes never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"nvcc: {time.perf_counter() - t0:.1f} s -> {out}")
        print((proc.stdout + proc.stderr).strip())
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every
    entry point's ``argtypes``/``restype`` declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # ws1, ws2, lmat, h_ext, num_valid (may be null), g, part_val,
    # part_lag, vals, lags, vals2, lags2 (both null without top-2);
    # programs, K, B, D, h_len, num_lags, m_pad, windows, share_h, sep;
    # stream
    lib.caf_fused_stein_rank.argtypes = [vp] * 12 + [ci] * 10 + [vp]
    lib.caf_fused_stein_rank.restype = ci
    lib.caf_fused_stein_lag_tile.argtypes = []
    lib.caf_fused_stein_lag_tile.restype = ci
    # needle, n, h_br, tw, rates, k, m, outputs..., stream
    lib.caf_filterbank_peak.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp, vp,
                                        vp]
    lib.caf_filterbank_peak.restype = ci
    lib.caf_filterbank_surface.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp,
                                           vp]
    lib.caf_filterbank_surface.restype = ci
    lib.caf_cuda_error_string.argtypes = [ci]
    lib.caf_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
