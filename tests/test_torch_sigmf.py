"""SigMF recording I/O: the port's numpy copy (``caf_cookoff_tpu_torch/
utils/sigmf.py``) against the JAX package's module on the same inputs."""

import json
import sys

import numpy as np
import pytest

from caf_cookoff_tpu.utils import sigmf as jsig
from caf_cookoff_tpu_torch.utils import sigmf as tsig


def _samples(n=1000, dtype=np.complex64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


def _read_both(path):
    return [open(path + ext, "rb").read()
            for ext in (".sigmf-data", ".sigmf-meta")]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32])
def test_write_sigmf_identical_bytes_and_meta(tmp_path, dtype):
    """Both packages write the same data bytes and the same meta text,
    with description, captures, annotations and extra global keys (real
    input is stored as cf32)."""
    x = _samples(dtype=np.complex128 if dtype is np.complex128
                 else np.complex64)
    if dtype is np.float32:
        x = x.real.astype(np.float32)
    kw = dict(description="chirp", captures=[{"core:sample_start": 0},
                                             {"core:sample_start": 400}],
              annotations=[tsig.caf_annotation(7, 100, 1.5, 2.0)],
              extra_global={"core:author": "test"})
    paths = []
    for mod, name in ((jsig, "jax"), (tsig, "port")):
        data, meta = mod.write_sigmf(str(tmp_path / name), x, 96_000.0, **kw)
        assert data.endswith(".sigmf-data") and meta.endswith(".sigmf-meta")
        paths.append(str(tmp_path / name))
    assert _read_both(paths[0]) == _read_both(paths[1])
    meta = json.loads(_read_both(paths[1])[1])
    want = "cf64_le" if dtype is np.complex128 else "cf32_le"
    assert meta["global"]["core:datatype"] == want
    assert meta["global"]["core:sample_rate"] == 96_000.0


@pytest.mark.parametrize("suffix", ["", ".sigmf-data", ".sigmf-meta"])
def test_read_sigmf_matches_jax(tmp_path, suffix):
    x = _samples(dtype=np.complex128)
    base = str(tmp_path / "rec")
    tsig.write_sigmf(base, x, 48_000.0,
                     captures=[{"core:sample_start": 0},
                               {"core:sample_start": 300},
                               {"core:sample_start": 650}])
    got, want = tsig.read_sigmf(base + suffix), jsig.read_sigmf(base + suffix)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.samples.dtype == np.complex128 and got.datatype == "cf64_le"
    assert (got.sample_rate, got.global_meta, got.captures,
            got.annotations) == (want.sample_rate, want.global_meta,
                                 want.captures, want.annotations)
    assert got.segment_bounds() == want.segment_bounds() == [
        (0, 300), (300, 350), (650, 350)]
    for i in range(3):
        np.testing.assert_array_equal(got.segment(i), want.segment(i))
    with pytest.raises(IndexError):
        got.segment(3)


def test_read_sigmf_rejects_unknown_datatype(tmp_path):
    base = str(tmp_path / "rec")
    tsig.write_sigmf(base, _samples(), 48_000.0,
                     extra_global={"core:datatype": "ri16_le"})
    for mod in (tsig, jsig):
        with pytest.raises(ValueError, match="unsupported SigMF datatype"):
            mod.read_sigmf(base)


def test_annotate_detection_matches_jax(tmp_path):
    """Appending a detection (rebased to its capture segment) leaves the
    same meta in both packages."""
    metas = []
    for mod, name in ((jsig, "jax"), (tsig, "port")):
        base = str(tmp_path / name)
        mod.write_sigmf(base, _samples(), 48_000.0,
                        captures=[{"core:sample_start": 0},
                                  {"core:sample_start": 500}])
        ann = mod.caf_annotation(202, 100, 69.25, 3.5, needle_id="n",
                                 comment="c")
        mod.annotate_detection(base + ".sigmf-meta", ann, segment=1)
        mod.annotate_detection(base + ".sigmf-meta",
                               mod.caf_annotation(5, 10, -1.0, 1.0))
        metas.append(open(base + ".sigmf-meta").read())
        with pytest.raises(IndexError):
            mod.annotate_detection(base, ann, segment=2)
    assert metas[0] == metas[1]
    anns = json.loads(metas[1])["annotations"]
    assert [a["core:sample_start"] for a in anns] == [5, 702]


def test_follow_sigmf_matches_jax(tmp_path):
    base = str(tmp_path / "rec")
    x = _samples(n=10_000)
    tsig.write_sigmf(base, x, 48_000.0)
    chunks = [list(mod.follow_sigmf(base, chunk=4096, poll_s=0.01,
                                    idle_timeout_s=0.03))
              for mod in (tsig, jsig)]
    assert [len(c) for c in chunks[0]] == [4096, 4096, 1808]
    for a, b in zip(*chunks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(chunks[0]), x)


def test_record_capture_needs_sounddevice(tmp_path, monkeypatch):
    """Without the optional package both raise the same RuntimeError
    type, naming it; nothing is written."""
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    for mod in (tsig, jsig):
        with pytest.raises(RuntimeError, match="sounddevice"):
            mod.record_capture(str(tmp_path / "cap"), 48_000.0, seconds=0.1)
    assert not list(tmp_path.iterdir())
