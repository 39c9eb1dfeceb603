"""Signal I/O in the reference's fixture formats.

* ``.c64`` — interleaved little-endian float32 I/Q;
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


def write_c64(path: PathLike, samples: np.ndarray) -> None:
    """Write complex samples as interleaved little-endian f32 I/Q."""
    np.asarray(samples).astype("<c8").tofile(os.fspath(path))
