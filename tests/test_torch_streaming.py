"""The port's StreamingCAF against the JAX package's, on the CPU: the
cuFFT streams (single peak and lattice), the Stein stream at one peak,
the detections, the chunk handling and the errors.

The same numpy captures, made from seeds, go through both packages
chunk by chunk.  cuFFT streams: every chunk's (freq, lag) identical and
its value within rtol 1e-4.  Stein streams: chunk values are K1's coarse
ranks (the port's plain K1 in f32 with bf16 operands, JAX's Pallas
kernel in interpret mode), compared at rtol 2e-2; ``best()`` re-scores
exactly, so its (freq, lag) are identical and its value within rtol
1e-4.  Floors within rtol 1e-4, searched cells equal.  The Stein
lattices are in ``test_torch_streaming_stein.py``.
"""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models.stein import \
    stein_overlap_save_peak as jax_stein_os_peak
from caf_cookoff_tpu.models.streaming import StreamingCAF as JaxStream
from caf_cookoff_tpu_torch import StreamingCAF, VmemBudgetError
from caf_cookoff_tpu_torch.ops.fused_stein import check_kernel_shape
from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peak

torch.set_num_threads(1)

FS = 48_000.0


def _capture(needle, truths, total, noise=1e-4, seed=0):
    """Noise with copies of ``needle`` at (freq_hz, lag, amp) truths."""
    rng = np.random.default_rng(seed)
    cap = (noise * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total))).astype(np.complex64)
    n, t = len(needle), np.arange(len(needle))
    for f, lag, amp in truths:
        end = min(lag + n, total)
        cap[lag:end] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)[:end - lag]
    return cap


def _noise_needle(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _stream(engine, capture, splits):
    """Feed ``capture`` cut at ``splits``: (per-chunk outputs, best)."""
    chunks = [engine.process(capture[a:b])
              for a, b in zip(splits[:-1], splits[1:])]
    return chunks, engine.best()


def _both(needle, freqs, capture, splits, **kw):
    """The port's and JAX's streams over the same chunks."""
    port = StreamingCAF(needle, freqs, FS, device="cpu", **kw)
    jax = JaxStream(needle, freqs, FS, **kw)
    return (port, *_stream(port, capture, splits)), \
        (jax, *_stream(jax, capture, splits))


def _assert_same_stream(got, want, chunk_rtol):
    (port, chunks, best), (jax, jchunks, jbest) = got, want
    for c, j in zip(chunks, jchunks):
        if chunk_rtol <= 1e-4:
            assert c[:2] == j[:2]
        assert c[2] == pytest.approx(j[2], rel=chunk_rtol)
    assert best[:2] == jbest[:2]
    assert best[2] == pytest.approx(jbest[2], rel=1e-4)
    assert port.samples_seen == jax.samples_seen
    assert port.searched_cells() == jax.searched_cells()
    assert port.noise_floor() == pytest.approx(jax.noise_floor(), rel=1e-4)


def _tiles(total, chunk):
    return list(range(0, total, chunk)) + [total]


# (name, n, total, (freq, lag), grid, splits, chunk_len) — the cuFFT
# cases of tests/test_models.py.
CUFFT_CASES = [
    ("matches_overlap_save", 256, 8192, (750.0, 5000),
     np.arange(-2000.0, 2000.0, 250.0), _tiles(8192, 1024), None),
    ("straddles_a_chunk_edge", 128, 2048, (0.0, 512 - 64),
     np.zeros(1), _tiles(2048, 512), None),
    ("uneven_and_oversized", 64, 3000, (-300.0, 1777),
     np.arange(-600.0, 600.0, 100.0), [0, 700, 1200, 1201, 2900, 3000],
     None),
    ("pinned_short_last_chunk", 64, 2500, (200.0, 2100),
     np.arange(-600.0, 600.0, 100.0), _tiles(2500, 1024), 1024),
]


@pytest.mark.parametrize("name,n,total,truth,grid,splits,chunk_len",
                         CUFFT_CASES, ids=[c[0] for c in CUFFT_CASES])
def test_cufft_stream_matches_jax(name, n, total, truth, grid, splits,
                                  chunk_len):
    needle = _noise_needle(n, seed=len(name))
    capture = _capture(needle, [(*truth, 1.0)], total, seed=n)
    freqs = grid.astype(np.float32)
    got, want = _both(needle, freqs, capture, splits, chunk_len=chunk_len)
    _assert_same_stream(got, want, 1e-4)
    assert got[2][:2] == truth
    assert got[0].backend == want[0].backend == "xla"
    if name == "matches_overlap_save":
        os_peak = overlap_save_peak(needle, capture, freqs, FS, device="cpu")
        assert os_peak[:2] == truth
        assert got[2][2] == pytest.approx(os_peak[2], rel=1e-5)


def test_stein_stream_matches_jax():
    """tests/test_models.py's Stein streams: even 1024-sample chunks, then
    uneven ones (a 1-sample chunk and an oversized one) on a pinned
    length; the chunk values are coarse (rtol 2e-2), ``best()`` exact."""
    needle = _noise_needle(512, seed=23)
    truth = (750.0, 5321)
    capture = _capture(needle, [(*truth, 1.0)], 8192, seed=24)
    freqs = np.arange(-1000.0, 1000.0, 125.0, dtype=np.float32)
    for splits in (_tiles(8192, 1024), [0, 700, 701, 6000, 8192]):
        got, want = _both(needle, freqs, capture, splits, backend="stein",
                          chunk_len=1024)
        _assert_same_stream(got, want, 2e-2)
        assert got[2][:2] == truth
        assert got[0].backend == "xla"
        # The emitter's chunk ranks the right bin and lag in both.
        hit = [c[:2] for c in got[1] if c[:2] == truth]
        assert hit and hit == [c[:2] for c in want[1] if c[:2] == truth]


def test_cufft_lattice_stream_matches_jax():
    """tests/test_multi_emitter.py's three emitters, one straddling the
    8192-sample chunk edge at 40960: the same lattice as JAX's stream."""
    needle = _noise_needle(1024, seed=5)
    truths = [(-30.0, 9000, 1.0), (45.0, 40800, 0.8), (10.0, 60000, 0.6)]
    capture = _capture(needle, truths, 65536, seed=6)
    freqs = np.arange(-100, 100, 2.5, dtype=np.float32)
    got, want = _both(needle, freqs, capture, _tiles(65536, 8192),
                      num_peaks=4)
    _assert_same_stream(got, want, 1e-4)
    (fr, lg, vv), (jf, jl, jv) = got[0].peaks(), want[0].peaks()
    np.testing.assert_array_equal(fr, np.asarray(jf))
    np.testing.assert_array_equal(lg, np.asarray(jl))
    np.testing.assert_allclose(vv, np.asarray(jv), rtol=1e-4)
    assert [(float(f), int(l)) for f, l in zip(fr[:3], lg[:3])] == \
        [(f, lag) for f, lag, _ in truths]
    assert got[2][:2] == (-30.0, 9000)


# tests/test_detection.py's scene: two emitters over unit noise.
DET_N, DET_TOTAL = 512, 4096
DET_FREQS = np.arange(-100.0, 100.1, 2.5, dtype=np.float32)


def _detections(engine):
    fr, lg, vv, snr = engine.peaks(min_snr_db="auto", with_snr=True)
    return ([(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
             if np.isfinite(v)], np.asarray(vv), np.asarray(snr))


@pytest.mark.parametrize("signal", [True, False])
def test_cufft_detections_match_jax(signal):
    """``peaks(min_snr_db="auto", with_snr=True)``: the same detections,
    SNRs within 1e-3 dB, the same measured floor — two emitters found,
    and none in a noise-only stream."""
    needle = _noise_needle(DET_N, seed=7)
    truths = [(30.0, 800, 1.0), (-60.0, 2500, 0.7)] if signal else []
    capture = _capture(needle, truths, DET_TOTAL, noise=1.0, seed=99)
    got, want = _both(needle, DET_FREQS, capture, _tiles(DET_TOTAL, 1024),
                      chunk_len=1024, num_peaks=4)
    _assert_same_stream(got, want, 1e-4)
    det, vv, snr = _detections(got[0])
    jdet, jvv, jsnr = _detections(want[0])
    assert det == jdet
    # tests/test_detection.py's bound: within the fs/N ~ 94 Hz doppler
    # mainlobe, where noise wobbles the argmax a few 2.5 Hz bins.
    assert len(det) == len(truths)
    for (f, lag), (tf, tlag, _) in zip(det, truths):
        assert abs(f - tf) <= 15.0 and abs(lag - tlag) <= 2
    np.testing.assert_array_equal(np.isfinite(vv), np.isfinite(jvv))
    fin = np.isfinite(jsnr)
    np.testing.assert_allclose(snr[fin], jsnr[fin], atol=1e-3)


def test_stream_errors_match_jax():
    needle = _noise_needle(256, seed=0)
    freqs = np.array([0.0], np.float32)
    for cls, kw in ((StreamingCAF, {"device": "cpu"}), (JaxStream, {})):
        with pytest.raises(ValueError, match="empty signal"):
            cls(needle[:0], freqs, FS, **kw)
        s = cls(needle, freqs, FS, **kw)
        with pytest.raises(ValueError, match="empty signal"):
            s.process(needle[:0])
        with pytest.raises(ValueError, match="num_peaks=1"):
            s.peaks()
        assert s.noise_floor() == 0.0 and s.searched_cells() == 0
    with pytest.raises(ValueError, match="unknown backend"):
        StreamingCAF(needle, freqs, FS, backend="nope", device="cpu")


def test_stein_stream_refuses_k1_rows_at_construction():
    """A 4096-sample needle on a +-1000 Hz grid at 48 kHz gives D = 8, so
    2B = 1024 rows, past one block's shared memory: K1 shares them over
    a cluster of 2 blocks a lag tile, and the port's Stein stream now
    takes the shape that JAX's takes.  Over a short capture (two 4096-
    sample chunks, an emitter at 355 Hz and lag 1500) its ``best()`` is
    JAX's ``stein_overlap_save_peak`` on the same capture ((freq, lag)
    identical, value rtol 1e-4; JAX's own Stein stream interprets its
    Pallas kernel for ~50 s here) and the port's cuFFT stream's.  Only
    past K1's ceiling does construction still raise VmemBudgetError."""
    needle = _noise_needle(4096, seed=1)
    freqs = np.arange(-1000.0, 1000.0, 5.0, dtype=np.float32)
    capture = _capture(needle, [(float(freqs[271]), 1500, 1.0)], 8192)
    stein = StreamingCAF(needle, freqs, FS, backend="stein", device="cpu")
    assert stein._lmat.shape[1] == 1024 and stein._group == 8
    assert check_kernel_shape(1024, 8).cluster == 2
    _, best = _stream(stein, capture, _tiles(8192, 4096))
    want = jax_stein_os_peak(needle, capture, freqs, FS)
    cufft = StreamingCAF(needle, freqs, FS, device="cpu")
    _, cbest = _stream(cufft, capture, _tiles(8192, 4096))
    assert best[:2] == want[:2] == cbest[:2] == (float(freqs[271]), 1500)
    assert best[2] == pytest.approx(want[2], rel=1e-4)
    assert best[2] == pytest.approx(cbest[2], rel=1e-4)
    # +-500 Hz (config 3's grid): D = 16, 2B = 512, one block a tile.
    StreamingCAF(needle, freqs / 2, FS, backend="stein", device="cpu")
    # Past the ceiling: 2B = 2 * 5120 rows at D = 8.
    with pytest.raises(VmemBudgetError, match="2B = 10240"):
        StreamingCAF(_noise_needle(40960, seed=2), freqs, FS,
                     backend="stein", device="cpu")


def test_stream_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    needle = _noise_needle(64, seed=2)
    for backend in ("xla", "stein"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StreamingCAF(needle, np.zeros(1, np.float32), FS,
                         backend=backend)


# tests/test_consistency_fuzz.py's long captures: (seed, n, total, lag,
# f_idx, grid_start, grid_step, grid_bins, chunk).
LONG_CASES = [
    (10, 512, 16384, 0, 2, -400.0, 50.0, 16, 2048),       # zero lag
    (11, 1024, 32768, 31744, 5, -100.0, 12.5, 16, 4096),  # last full lag
    (12, 1000, 20000, 13777, 7, -750.0, 125.0, 12, 3000),  # non-pow2 all
    (13, 256, 8192, 7936, 3, -250.0, 62.5, 8, 1024),      # last-sample lag
    (14, 2048, 65536, 50123, 9, -8000.0, 1000.0, 16, 8192),  # wide span
]


@pytest.mark.parametrize("seed,n,total,lag,f_idx,g0,gs,gk,chunk",
                         LONG_CASES)
def test_long_capture_streams_agree_fuzz(seed, n, total, lag, f_idx, g0, gs,
                                         gk, chunk):
    """The port's cuFFT stream equals JAX's and the planted emitter; its
    Stein stream (where the span admits a block length) finds the same
    emitter with the same exact value."""
    rng = np.random.default_rng(seed)
    freqs = (g0 + gs * np.arange(gk)).astype(np.float32)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    span = min(n, total - lag)
    hay[lag:lag + span] += (needle * np.exp(
        2j * np.pi * float(freqs[f_idx]) * np.arange(n) / FS)
    ).astype(np.complex64)[:span]
    want = (float(freqs[f_idx]), lag)
    got, jax = _both(needle, freqs, hay, _tiles(total, chunk),
                     chunk_len=chunk)
    _assert_same_stream(got, jax, 1e-4)
    assert got[2][:2] == want
    if max(abs(freqs)) <= FS / 32:
        s = StreamingCAF(needle, freqs, FS, chunk_len=chunk, backend="stein",
                         device="cpu")
        stein = _stream(s, hay, _tiles(total, chunk))[1]
        assert stein[:2] == want
        assert stein[2] == pytest.approx(got[2][2], rel=1e-4)


# tests/test_consistency_fuzz.py's multi-emitter captures: (seed, n,
# total, chunk, [(f_idx, lag, amp)]).
MULTI_CASES = [
    (20, 1024, 32768, 8192, [(3, 9000, 1.0), (11, 22000, 0.7)]),
    (21, 512, 16384, 2048, [(2, 500, 1.0), (9, 9100, 0.8),
                            (14, 15000, 0.6)]),
    (22, 1024, 24576, 4096, [(5, 4090, 1.0), (12, 4300, 0.75)]),
    (23, 2048, 65536, 8192, [(1, 63400, 1.0), (8, 31000, 0.65)]),
]


@pytest.mark.parametrize("seed,n,total,chunk,emitters", MULTI_CASES)
def test_stream_lattices_agree_fuzz(seed, n, total, chunk, emitters):
    """The port's Stein and cuFFT stream lattices and JAX's cuFFT stream
    lattice recover the same planted emitters (one spare slot), the
    cuFFT lattices identically."""
    rng = np.random.default_rng(seed)
    freqs = np.arange(-100, 100, 12.5, dtype=np.float32)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    truths = []
    for f_idx, lag, amp in emitters:
        f = float(freqs[f_idx])
        span = min(n, total - lag)
        hay[lag:lag + span] += (amp * needle * np.exp(
            2j * np.pi * f * t / FS)).astype(np.complex64)[:span]
        truths.append((f, lag))
    p = len(emitters) + 1
    got, jax = _both(needle, freqs, hay, _tiles(total, chunk),
                     chunk_len=chunk, num_peaks=p)
    _assert_same_stream(got, jax, 1e-4)
    rows = []
    for engine in (got[0], jax[0]):
        fr, lg, vv = engine.peaks()
        rows.append([(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
                     if np.isfinite(float(v))])
    s = StreamingCAF(needle, freqs, FS, chunk_len=chunk, num_peaks=p,
                     backend="stein", device="cpu")
    _stream(s, hay, _tiles(total, chunk))
    fr, lg, vv = s.peaks()
    stein = [(float(f), int(l)) for f, l, v in zip(fr, lg, vv)
             if np.isfinite(float(v))]
    assert rows[0] == rows[1]
    assert rows[0][:len(truths)] == stein[:len(truths)] == truths
