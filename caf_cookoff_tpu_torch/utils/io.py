"""Signal and surface I/O in the reference's file formats (a copy of the
JAX package's ``utils/io.py``; the files written are byte-identical).

* ``.c64`` — interleaved little-endian float32 I/Q (the fixture format);
* ``.f32`` — raw little-endian float32;
* surface dump — raw little-endian float64 rows (the Go reference's
  ``dump_surf``), or ``.npy``;
* complex128 binary — interleaved little-endian float64 I/Q;
* ground truth is encoded in fixture filenames
  (``chirp_{i}_T{+lag}samp_F{+off}Hz.c64``).
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional, Union

import numpy as np

PathLike = Union[str, os.PathLike]

_GROUND_TRUTH_RE = re.compile(
    r"chirp_(?P<idx>\d+)_T(?P<lag>[+-]\d+)samp_F(?P<freq>[+-]?\d+(?:\.\d+)?)Hz")


class GroundTruth(NamedTuple):
    index: int
    lag_samples: int
    freq_hz: float


def parse_ground_truth(path: PathLike) -> GroundTruth:
    """Recover the injected (lag, frequency offset) from a fixture filename."""
    name = os.path.basename(os.fspath(path))
    match = _GROUND_TRUTH_RE.search(name)
    if match is None:
        raise ValueError(f"no ground truth encoded in filename: {name!r}")
    return GroundTruth(index=int(match.group("idx")),
                       lag_samples=int(match.group("lag")),
                       freq_hz=float(match.group("freq")))


def load_c64(path: PathLike, count: Optional[int] = None) -> np.ndarray:
    """Read interleaved little-endian f32 I/Q as complex64."""
    data = np.fromfile(os.fspath(path), dtype="<c8",
                       count=-1 if count is None else count)
    return data.astype(np.complex64, copy=False)


def load_f32(path: PathLike, count: Optional[int] = None) -> np.ndarray:
    """Read raw little-endian float32 samples."""
    return np.fromfile(os.fspath(path), dtype="<f4",
                       count=-1 if count is None else count)


def c64_to_c128(samples: np.ndarray) -> np.ndarray:
    """Upcast complex64 -> complex128 (the Go and Rust references compute
    in double precision)."""
    return np.asarray(samples).astype(np.complex128)


def f32_to_c128(samples: np.ndarray) -> np.ndarray:
    """Real float32 -> complex128 with a zero imaginary part."""
    return np.asarray(samples, dtype=np.float64).astype(np.complex128)


def write_c64(path: PathLike, samples: np.ndarray) -> None:
    """Write complex samples as interleaved little-endian f32 I/Q."""
    np.asarray(samples).astype("<c8").tofile(os.fspath(path))


def write_c128(path: PathLike, samples: np.ndarray) -> None:
    """Write complex samples as interleaved little-endian f64 I/Q (numpy's
    complex128 layout)."""
    np.asarray(samples).astype("<c16").tofile(os.fspath(path))


def dump_surf(path: PathLike, surface: np.ndarray) -> None:
    """Dump a real surface as raw little-endian float64 rows, byte for
    byte the Go reference's ``dump_surf``."""
    np.asarray(surface).astype("<f8").tofile(os.fspath(path))


def load_surf(path: PathLike, num_rows: int) -> np.ndarray:
    """Read back a raw f64 surface dump, reshaped to (num_rows, -1)."""
    flat = np.fromfile(os.fspath(path), dtype="<f8")
    return flat.reshape(num_rows, -1)


def save_npy(path: PathLike, array: np.ndarray) -> None:
    """Save any array in .npy format (the self-describing option)."""
    np.save(os.fspath(path), np.asarray(array))
