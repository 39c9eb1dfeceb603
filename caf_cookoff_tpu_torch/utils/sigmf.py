"""SigMF recording I/O (numpy only; a copy of the JAX package's
``utils/sigmf.py``, which the port does not import).

The reference's real-world data path records SigMF: both GNU Radio
flowgraphs end in a ``sigmf_sink`` (``grc/generate.grc`` "Generate
Pulses" block ~line 660, ``grc/capture.grc:252`` in relative-time mode)
and the README's capture workflow CAFs those recordings against the
generated needles.  This module reads/writes the same format —
``<base>.sigmf-data`` (raw interleaved samples) + ``<base>.sigmf-meta``
(JSON) — and adds what the reference never closed the loop on: writing
CAF *results* back as SigMF annotations on the capture.

Only the core namespace is implemented (no extensions), complex float
datatypes ``cf32_le``/``cf64_le`` — the formats the reference's fixture
chain uses (.c64 files are exactly a SigMF ``cf32_le`` data file with no
meta).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

PathLike = Union[str, os.PathLike]

SIGMF_VERSION = "1.0.0"

_DATATYPES = {
    "cf32_le": np.dtype("<c8"),
    "cf64_le": np.dtype("<c16"),
}
_DTYPE_NAMES = {v: k for k, v in _DATATYPES.items()}


@dataclasses.dataclass
class SigMFRecording:
    """An in-memory SigMF recording: samples + metadata."""

    samples: np.ndarray
    sample_rate: float
    global_meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    captures: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    annotations: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def datatype(self) -> str:
        return _DTYPE_NAMES[np.dtype(self.samples.dtype)]

    def segment_bounds(self) -> List[Tuple[int, int]]:
        """[(start, count)] per capture segment, in data-file samples.

        SigMF ``captures`` partition the contiguous data stream: each
        segment runs from its ``core:sample_start`` to the next
        capture's start (or end of file).  A recording with no captures
        list is one segment covering everything — round 1 treated the
        list as an opaque passthrough, which broke absolute indexing for
        multi-capture recordings (``grc/capture.grc:252`` records one
        capture per retune/burst).
        """
        total = len(self.samples)
        if not self.captures:
            return [(0, total)]
        starts = sorted(int(c.get("core:sample_start", 0))
                        for c in self.captures)
        bounds = []
        for i, s in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else total
            bounds.append((s, max(0, end - s)))
        return bounds

    def segment(self, index: int) -> np.ndarray:
        """Samples of capture segment ``index`` (data-file order)."""
        bounds = self.segment_bounds()
        if not 0 <= index < len(bounds):
            raise IndexError(
                f"segment {index} out of range (recording has "
                f"{len(bounds)} capture segment(s))")
        start, count = bounds[index]
        return self.samples[start:start + count]


def _base(path: PathLike) -> str:
    path = os.fspath(path)
    for suffix in (".sigmf-data", ".sigmf-meta"):
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


def write_sigmf(path: PathLike, samples: np.ndarray, sample_rate: float,
                *, description: Optional[str] = None,
                captures: Optional[List[Dict[str, Any]]] = None,
                annotations: Optional[List[Dict[str, Any]]] = None,
                extra_global: Optional[Dict[str, Any]] = None
                ) -> Tuple[str, str]:
    """Write ``<base>.sigmf-data`` + ``<base>.sigmf-meta``; returns paths."""
    base = _base(path)
    samples = np.asarray(samples)
    if samples.dtype not in _DTYPE_NAMES:
        samples = samples.astype(np.complex64)
    data_path = base + ".sigmf-data"
    meta_path = base + ".sigmf-meta"
    samples.tofile(data_path)
    global_meta = {
        "core:datatype": _DTYPE_NAMES[np.dtype(samples.dtype)],
        "core:sample_rate": float(sample_rate),
        "core:version": SIGMF_VERSION,
    }
    if description:
        global_meta["core:description"] = description
    if extra_global:
        global_meta.update(extra_global)
    meta = {
        "global": global_meta,
        "captures": captures if captures is not None
        else [{"core:sample_start": 0}],
        "annotations": annotations or [],
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return data_path, meta_path


def read_sigmf(path: PathLike) -> SigMFRecording:
    """Load a recording from either .sigmf-data/-meta path or the base."""
    base = _base(path)
    with open(base + ".sigmf-meta") as f:
        meta = json.load(f)
    g = meta.get("global", {})
    datatype = g.get("core:datatype", "cf32_le")
    if datatype not in _DATATYPES:
        raise ValueError(f"unsupported SigMF datatype {datatype!r} "
                         f"(supported: {sorted(_DATATYPES)})")
    samples = np.fromfile(base + ".sigmf-data", dtype=_DATATYPES[datatype])
    return SigMFRecording(
        samples=samples,
        sample_rate=float(g.get("core:sample_rate", 0.0)),
        global_meta=g,
        captures=meta.get("captures", []),
        annotations=meta.get("annotations", []),
    )


def caf_annotation(lag_samples: int, needle_len: int, freq_offset_hz: float,
                   peak_value: float, *,
                   needle_id: Optional[str] = None,
                   comment: Optional[str] = None) -> Dict[str, Any]:
    """A SigMF annotation describing one CAF detection on a capture.

    ``sample_start``/``sample_count`` mark where the needle's delayed
    copy sits in the capture; the frequency offset and peak value ride
    in a ``caf:`` namespace.
    """
    ann: Dict[str, Any] = {
        "core:sample_start": int(lag_samples),
        "core:sample_count": int(needle_len),
        "caf:freq_offset_hz": float(freq_offset_hz),
        "caf:peak_value": float(peak_value),
    }
    if needle_id:
        ann["caf:needle"] = needle_id
    if comment:
        ann["core:comment"] = comment
    return ann


def annotate_detection(meta_path: PathLike, annotation: Dict[str, Any],
                       *, segment: Optional[int] = None) -> None:
    """Append a detection annotation to an existing .sigmf-meta file.

    ``segment`` rebases a segment-relative ``core:sample_start`` to the
    absolute data-file index of that capture segment, so detections on
    a multi-capture recording annotate the right samples.
    """
    base = _base(meta_path)
    with open(base + ".sigmf-meta") as f:
        meta = json.load(f)
    if segment is not None:
        captures = meta.get("captures", [])
        starts = sorted(int(c.get("core:sample_start", 0))
                        for c in captures) or [0]
        if not 0 <= segment < len(starts):
            raise IndexError(f"segment {segment} out of range "
                             f"({len(starts)} capture segment(s))")
        annotation = dict(annotation)
        annotation["core:sample_start"] = (
            int(annotation.get("core:sample_start", 0)) + starts[segment])
    meta.setdefault("annotations", []).append(annotation)
    meta["annotations"].sort(
        key=lambda a: a.get("core:sample_start", 0))
    with open(base + ".sigmf-meta", "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def follow_sigmf(path: PathLike, *, chunk: int = 4096,
                 poll_s: float = 0.25, idle_timeout_s: float = 5.0):
    """Generator yielding new samples as a .sigmf-data file GROWS.

    The live-capture analog of ``grc/capture.grc`` (audio_source ->
    sigmf_sink) for this side of the pipe: point it at the recording a
    flowgraph (or :func:`record_capture`) is writing and feed the
    chunks to a streaming CAF consumer.
    Yields up to ``chunk`` samples at a time; ends after
    ``idle_timeout_s`` with no growth.
    """
    import time as _time

    base = _base(path)
    with open(base + ".sigmf-meta") as f:
        meta = json.load(f)
    dt = _DATATYPES[meta.get("global", {}).get("core:datatype", "cf32_le")]
    item = dt.itemsize
    offset = 0
    idle = 0.0
    data_path = base + ".sigmf-data"
    while idle < idle_timeout_s:
        avail = (os.path.getsize(data_path) - offset) // item
        if avail <= 0:
            _time.sleep(poll_s)
            idle += poll_s
            continue
        idle = 0.0
        take = min(avail, chunk)
        with open(data_path, "rb") as f:
            f.seek(offset)
            buf = f.read(take * item)
        got = len(buf) // item
        if not got:
            _time.sleep(poll_s)
            idle += poll_s
            continue
        offset += got * item
        yield np.frombuffer(buf[: got * item], dtype=dt)


def record_capture(path: PathLike, sample_rate: float, *,
                   seconds: Optional[float] = None,
                   device: Optional[int] = None,
                   channels: int = 1) -> Tuple[str, str]:
    """Record an audio-band capture to SigMF (``grc/capture.grc``'s
    ``audio_source -> sigmf_sink`` without GNU Radio).

    Requires the optional ``sounddevice`` package (not bundled); raises
    a clear error otherwise.  Real samples are recorded and stored as
    the complex cf32_le baseband the CAF engines expect (imag = 0).
    """
    try:
        import sounddevice as sd
    except ImportError as exc:  # pragma: no cover - optional dependency
        raise RuntimeError(
            "live capture needs the optional 'sounddevice' package "
            "(pip install sounddevice); to CAF an existing recording "
            "use `python -m caf_cookoff_tpu_torch run/batch` on the "
            ".sigmf files, or follow_sigmf() to tail one being written"
        ) from exc

    frames = int((seconds or 5.0) * sample_rate)
    audio = sd.rec(frames, samplerate=int(sample_rate),
                   channels=channels, dtype="float32", device=device)
    sd.wait()  # pragma: no cover - hardware path
    samples = audio[:, 0].astype(np.complex64)
    return write_sigmf(path, samples, sample_rate,
                       description="caf-tpu live capture")
