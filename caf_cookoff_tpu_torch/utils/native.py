"""ctypes bindings for libcafio, the native C++ signal I/O of
``native/cafio.cpp`` (the JAX package's ``utils/native.py``, built
elsewhere).

Files and in-memory complex buffers are deinterleaved straight into
planar (re, im) float32 planes, with mmap'd reads and multi-threaded
conversion for large captures; writes go the other way.

The library is built from ``native/cafio.cpp`` with g++ (the flags of
``native/Makefile``) into ``build/native/`` under the checkout, named by
a hash of the source, at first use; ``native/`` itself is never written.
Where it cannot be built or loaded, every function falls back to numpy
(the library is host I/O, not a device kernel), as the JAX package's
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "cafio.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def library_path() -> pathlib.Path:
    """``build/native/libcafio_<hash>.so``: an edited source rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes() if SOURCE.exists() else b"")
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcafio_{digest.hexdigest()[:16]}.so"


def build_native(quiet: bool = True) -> bool:
    """Compile the library with ``$CXX`` (default g++); True on success.
    The output is linked under a temporary name and renamed, so
    concurrent processes never load a half-written library."""
    out = library_path()
    if out.exists():
        return True
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = pathlib.Path(tmp_dir) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=quiet)
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.cafio_file_samples.argtypes = [ctypes.c_char_p]
    lib.cafio_file_samples.restype = i64
    lib.cafio_load_c64_split.argtypes = [ctypes.c_char_p, fp, fp, i64, i64]
    lib.cafio_load_c64_split.restype = i64
    lib.cafio_deinterleave_c64.argtypes = [fp, fp, fp, i64]
    lib.cafio_deinterleave_c64.restype = None
    lib.cafio_interleave_c64.argtypes = [fp, fp, fp, i64]
    lib.cafio_interleave_c64.restype = None
    lib.cafio_write_c64.argtypes = [ctypes.c_char_p, fp, fp, i64]
    lib.cafio_write_c64.restype = i64
    lib.cafio_write_f64.argtypes = [ctypes.c_char_p, dp, i64]
    lib.cafio_write_f64.restype = i64
    return lib


def get_lib(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """The bound library, built on first use if needed; None where it is
    unavailable (callers fall back to numpy).  Loading is tried once a
    process."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = library_path()
    if not path.exists() and auto_build:
        build_native()
    if path.exists():
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except OSError:
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def file_samples(path) -> int:
    lib = get_lib()
    if lib is None:
        return os.path.getsize(os.fspath(path)) // 8
    n = lib.cafio_file_samples(os.fspath(path).encode())
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)


def load_c64_split(path, count: int = -1,
                   offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """mmap + deinterleave a .c64 file into (re, im) float32 planes."""
    lib = get_lib()
    path = os.fspath(path)
    if lib is None:
        data = np.fromfile(path, dtype="<c8",
                           count=count, offset=offset * 8)
        return (np.ascontiguousarray(data.real),
                np.ascontiguousarray(data.imag))
    total = file_samples(path)
    n = total - offset if count < 0 else min(count, total - offset)
    n = max(n, 0)
    re = np.empty(n, dtype=np.float32)
    im = np.empty(n, dtype=np.float32)
    got = lib.cafio_load_c64_split(path.encode(), _fptr(re), _fptr(im),
                                   n, offset)
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return re[:got], im[:got]


def deinterleave(interleaved_c64: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """complex64 array -> (re, im) planes, threaded for large inputs."""
    x = np.ascontiguousarray(interleaved_c64, dtype=np.complex64)
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    flat = x.view(np.float32).reshape(-1)
    re = np.empty(x.shape, dtype=np.float32)
    im = np.empty(x.shape, dtype=np.float32)
    lib.cafio_deinterleave_c64(_fptr(flat), _fptr(re.reshape(-1)),
                               _fptr(im.reshape(-1)), x.size)
    return re, im


def write_c64_split(path, re: np.ndarray, im: np.ndarray) -> int:
    """(re, im) planes -> interleaved .c64 file; returns the samples
    written."""
    lib = get_lib()
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    if lib is None:
        out = np.empty(re.size, dtype=np.complex64)
        out.real, out.imag = re.reshape(-1), im.reshape(-1)
        out.tofile(os.fspath(path))
        return re.size
    n = lib.cafio_write_c64(os.fspath(path).encode(),
                            _fptr(re.reshape(-1)), _fptr(im.reshape(-1)),
                            re.size)
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)


def write_f64(path, data: np.ndarray) -> int:
    """Raw little-endian f64 dump (the Go reference's ``dump_surf``)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if lib is None:
        data.tofile(os.fspath(path))
        return data.size
    n = lib.cafio_write_f64(
        os.fspath(path).encode(),
        data.reshape(-1).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        data.size)
    if n < 0:
        raise OSError(-n, os.strerror(-n), os.fspath(path))
    return int(n)
