"""The port's Stein stream lattices (K1's top-2 mode (e) once a chunk, the
carried windows and their exact re-score) against the JAX package's
StreamingCAF on the CPU, where JAX runs its Pallas kernel in interpret
mode.

Scenes are tests/test_multi_emitter.py's and tests/test_detection.py's:
the same numpy captures through both packages.  Re-scored lattices:
(freq, lag) identical, values within rtol 1e-4; chunk values are coarse
(rtol 2e-2); floors within rtol 1e-4.  JAX's kernel keeps a same-bin
pair exactly only past 2*sep, the port's past sep: the last test shows
a pair in between that the port keeps and JAX's stream drops.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models.streaming import StreamingCAF as JaxStream
from caf_cookoff_tpu_torch import StreamingCAF
from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_surface
from caf_cookoff_tpu_torch.ops.peak import find_peaks, resolution_cell
from tests.test_torch_streaming import (DET_FREQS, DET_N, DET_TOTAL, FS,
                                        _assert_same_stream, _both, _capture,
                                        _detections, _noise_needle, _tiles)

torch.set_num_threads(1)

FREQS = np.arange(-100, 100, 2.5, dtype=np.float32)


def _rows(peaks):
    fr, lg, vv = peaks[:3]
    return [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
            if np.isfinite(float(v))]


# (name, truths (freq, lag, amp), total, num_peaks)
SCENES = [
    # Three emitters, one straddling the chunk edge at 40960.
    ("three_emitters", [(-30.0, 9000, 1.0), (45.0, 40800, 0.8),
                        (10.0, 60000, 0.6)], 65536, 4),
    # Two emitters in one doppler bin inside one chunk window.
    ("same_bin", [(-30.0, 9000, 1.0), (-30.0, 12000, 0.7)], 32768, 2),
]


@pytest.mark.parametrize("name,truths,total,num_peaks", SCENES,
                         ids=[s[0] for s in SCENES])
def test_stein_lattice_stream_matches_jax(name, truths, total, num_peaks):
    needle = _noise_needle(1024, seed=5)
    capture = _capture(needle, truths, total, seed=6)
    got, want = _both(needle, FREQS, capture, _tiles(total, 8192),
                      backend="stein", num_peaks=num_peaks)
    _assert_same_stream(got, want, 2e-2)
    peaks, jpeaks = got[0].peaks(), want[0].peaks()
    assert _rows(peaks) == _rows(jpeaks) == [(f, l) for f, l, _ in truths]
    fin = np.isfinite(jpeaks[2])
    np.testing.assert_array_equal(np.isfinite(peaks[2]), fin)
    np.testing.assert_allclose(peaks[2][fin], jpeaks[2][fin], rtol=1e-4)
    assert got[2][:2] == truths[0][:2]


def test_stein_model_floor_detections_match_jax():
    """The Stein stream's model floor ``Σ|n|² · mean|h|²`` and its
    detections at the auto threshold: the same as JAX's."""
    needle = _noise_needle(DET_N, seed=7)
    truths = [(30.0, 800, 1.0), (-60.0, 2500, 0.7)]
    capture = _capture(needle, truths, DET_TOTAL, noise=1.0, seed=99)
    got, want = _both(needle, DET_FREQS, capture, _tiles(DET_TOTAL, 1024),
                      chunk_len=1024, num_peaks=4, backend="stein")
    _assert_same_stream(got, want, 2e-2)
    det, _, snr = _detections(got[0])
    jdet, _, jsnr = _detections(want[0])
    assert det == jdet
    assert len(det) >= 2
    for (f, lag), (tf, tlag, _) in zip(det, truths):
        assert abs(f - tf) <= 15.0 and abs(lag - tlag) <= 2
    fin = np.isfinite(jsnr)
    np.testing.assert_allclose(snr[fin], jsnr[fin], atol=1e-3)
    assert got[0].noise_floor() > 0


def test_stein_stream_keeps_a_pair_past_sep_that_jax_drops():
    """``exclude_lag`` = sep = 30; p1 five lags past a 512-lag tile edge
    of the window, a twin 8 lags before it (inside p1's cell: one
    detection) and p2 35 lags before it (past sep, within 2*sep).  JAX's
    kernel merges tiles greedily: the tile before p1 tops at the twin,
    which p2 sits within sep of, so p2 never reaches its lattice.  The
    port's K1 ranks the strongest lag past sep exactly, and its lattice
    equals NMS on the full overlap-save surface with the same windows."""
    n, total, chunk, sep = 1024, 16384, 8192, 30
    rng = np.random.default_rng(3)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    p1 = chunk - (n - 1) + 6 * 512 + 5          # second window's lag 3077
    truths = [(-30.0, p1, 1.0), (-30.0, p1 - 8, 0.9), (-30.0, p1 - 35, 0.6)]
    capture = _capture(needle, truths, total, seed=4)
    excl_f = resolution_cell(needle, FREQS, FS)[0]
    kw = dict(backend="stein", num_peaks=2, chunk_len=chunk,
              exclude_lag=sep)
    port = StreamingCAF(needle, FREQS, FS, device="cpu", **kw)
    jax = JaxStream(needle, FREQS, FS, **kw)
    for off in range(0, total, chunk):
        port.process(capture[off:off + chunk])
        jax.process(capture[off:off + chunk])
    surf = overlap_save_surface(needle, capture, FREQS, FS, device="cpu")
    want = find_peaks(surf, 2, excl_f, sep)
    fr, lg, vv = port.peaks()
    assert list(lg) == want.lag_idx.tolist() == [p1, p1 - 35]
    assert list(fr) == FREQS[want.freq_idx.numpy()].tolist()
    np.testing.assert_allclose(vv, want.value.numpy(), rtol=1e-4)
    jrows = _rows(jax.peaks())
    assert jrows[0] == (-30.0, p1)
    assert all(abs(lag - (p1 - 35)) > sep for _, lag in jrows)
