"""The streams and the windowed engines as compiled calls, on the CPU.

``StreamingCAF``'s steps now take the window's base lag and the chunk's
valid length as int32 tensors and return the advanced base lag, so one
compiled call (``ops/_graph``) serves every chunk.  Each step must be
the step it replaces bit for bit: the old steps, which took both as
Python ints, are kept here as the plain versions and driven over the
same seeded captures (an uneven last chunk, an oversized chunk, numpy
and tensor chunks, complex64 and complex128), the state compared after
every chunk.  The Stein model floor, now an f64 sum on the stream's
device, must equal the Python float's sum bit for bit; int32 overflow
must come where the JAX package's comes.  ``batched_stein_os_peak``'s
per-window lag bound, now made on the device, must equal the
``np.tile`` bound bit for bit.  The card's side is in
``tests/test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models.streaming import StreamingCAF as JaxStream
from caf_cookoff_tpu_torch import StreamingCAF
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import streaming as tst
from caf_cookoff_tpu_torch.models.overlap_save import streaming_peak
from caf_cookoff_tpu_torch.ops.peak import CafPeak, concat_peaks, merge_peaks
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal

FS = 48_000.0
FREQS = np.arange(-1000.0, 1000.0, 125.0, dtype=np.float32)
# Chunk sizes 512, 388 (short), 1300 (oversized: 512 + 512 + 276), 401
# and the uneven last 399 on a pinned length of 512.
SPLITS = [0, 512, 900, 2200, 2601, 3000]
MODES = ["cufft", "cufft_lattice", "stein", "stein_lattice"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The plain versions: the steps as they took Python-int lags before.
# ---------------------------------------------------------------------------


def _old_stream_step(s_conj, tail, chunk, best, fsum, fcnt, base_lag: int,
                     valid_len: int, needle_len: int):
    window = torch.cat([tail, chunk])
    local, wsum, wcnt = streaming_peak(
        s_conj, window, needle_len, chunk.shape[-1], lag_offset=base_lag,
        total_lags=base_lag + valid_len, with_floor=True)
    new_tail = window[valid_len:valid_len + needle_len - 1]
    return (tst._take(local.value > best.value, local, best), local,
            new_tail, fsum + wsum, fcnt + wcnt)


def _old_stream_lattice_step(s_conj, tail, chunk, best, fsum, fcnt,
                             base_lag: int, valid_len: int, needle_len: int,
                             num_peaks: int, exclude_freq: int,
                             exclude_lag: int):
    window = torch.cat([tail, chunk])
    local, wsum, wcnt = streaming_peak(
        s_conj, window, needle_len, chunk.shape[-1], lag_offset=base_lag,
        total_lags=base_lag + valid_len, num_peaks=num_peaks,
        exclude_freq=exclude_freq, exclude_lag=exclude_lag, with_floor=True)
    merged = merge_peaks(concat_peaks(best, local), num_peaks, exclude_freq,
                         exclude_lag)
    new_tail = window[valid_len:valid_len + needle_len - 1]
    return merged, local, new_tail, fsum + wsum, fcnt + wcnt


def _old_stein_stream_step(ws1, ws2, lmat, tail, chunk, best, bw, bw_start,
                           num_valid, base_lag: int, valid_len: int,
                           num_blocks: int, group: int, needle_len: int,
                           carry: int):
    wpad, (vals, idxs) = tst._stein_window(ws1, ws2, lmat, tail, chunk,
                                           num_blocks, group, num_valid,
                                           carry)
    vals = vals[:, 0]
    k_loc = torch.argmax(vals)
    tau_loc = idxs[k_loc, 0]
    local = CafPeak(vals[k_loc], k_loc.to(torch.int32), tau_loc + base_lag)
    take = local.value > best.value
    cand, start = tst._carry_slices(wpad, tau_loc, carry)
    new_tail = wpad[valid_len:valid_len + needle_len - 1]
    return (tst._take(take, local, best), local, new_tail,
            torch.where(take, cand, bw),
            torch.where(take, start + base_lag, bw_start))


def _old_stein_stream_lattice_step(ws1, ws2, lmat, tail, chunk, best, bws,
                                   bw_starts, num_valid, base_lag: int,
                                   valid_len: int, num_blocks: int,
                                   group: int, needle_len: int, carry: int,
                                   num_peaks: int, exclude_freq: int,
                                   exclude_lag: int):
    wpad, (vals, idxs, vals2, idxs2) = tst._stein_window(
        ws1, ws2, lmat, tail, chunk, num_blocks, group, num_valid, carry,
        want_top2=True, sep=exclude_lag)
    bins = torch.arange(vals.shape[0], dtype=torch.int32, device=vals.device)
    v2 = torch.where(vals2[:, 0] < 0, -math.inf, vals2[:, 0])
    cands = CafPeak(torch.cat([vals[:, 0], v2]), torch.cat([bins, bins]),
                    torch.cat([idxs[:, 0], idxs2[:, 0]]) + base_lag)
    chunk_lat = merge_peaks(cands, num_peaks, exclude_freq, exclude_lag)
    chunk_bws, starts = tst._carry_slices(wpad, chunk_lat.lag_idx - base_lag,
                                          carry)
    merged, sel = merge_peaks(concat_peaks(best, chunk_lat), num_peaks,
                              exclude_freq, exclude_lag, return_indices=True)
    sel = sel.long()
    new_bws = torch.cat([bws, chunk_bws])[sel]
    new_starts = torch.cat([bw_starts, starts + base_lag])[sel]
    local = CafPeak(*(x[0] for x in chunk_lat))
    new_tail = wpad[valid_len:valid_len + needle_len - 1]
    return merged, new_bws, new_starts, local, new_tail


def _old_energy(chunk) -> float:
    if isinstance(chunk, torch.Tensor):
        return float((chunk.real.square().sum()
                      + chunk.imag.square().sum()).item())
    return float(np.sum(chunk.real ** 2) + np.sum(chunk.imag ** 2))


class _OldStream:
    """The old ``_step`` over a new stream's constants and initial state:
    Python-int lags, the floor's energy summed in a Python float."""

    def __init__(self, s: StreamingCAF):
        self.s = s
        self.best = CafPeak(*(x.clone() for x in s._best))
        self.tail = s._tail.clone()
        self.fsum, self.fcnt = s._fsum.clone(), s._fcnt.clone()
        if s._stein:
            self.bw, self.bw_start = s._bw.clone(), s._bw_start.clone()
        self.base = s._base_lag
        self.h2 = 0.0

    def process(self, chunk):
        valid = int(chunk.shape[-1])
        fixed = self.s._chunk_len or valid
        if valid <= fixed:
            return self._step(chunk)
        best = None
        for off in range(0, valid, fixed):
            local = self._step(chunk[off:off + fixed])
            if best is None or local[2] > best[2]:
                best = local
        return best

    def _step(self, chunk):
        s, valid = self.s, int(chunk.shape[-1])
        if s._stein:
            self.h2 += _old_energy(chunk)
        ch = pad_to(as_signal(chunk, "cpu").to(s._cdtype), s._chunk_len)
        lattice = ((s._num_peaks, *s._exclude) if s._num_peaks > 1 else ())
        if s._stein:
            nv = torch.tensor([valid], dtype=torch.int32)
            ops = (*s._ws, s._lmat, self.tail, ch, self.best, self.bw,
                   self.bw_start, nv, self.base, valid, s._num_blocks,
                   s._group, s.needle_len, s._carry)
            if lattice:
                (self.best, self.bw, self.bw_start, local,
                 self.tail) = _old_stein_stream_lattice_step(*ops, *lattice)
            else:
                (self.best, local, self.tail, self.bw,
                 self.bw_start) = _old_stein_stream_step(*ops)
        else:
            ops = (s._s_conj, self.tail, ch, self.best, self.fsum,
                   self.fcnt, self.base, valid, s.needle_len)
            if lattice:
                (self.best, local, self.tail, self.fsum,
                 self.fcnt) = _old_stream_lattice_step(*ops, *lattice)
                local = CafPeak(*(x[0] for x in local))
            else:
                (self.best, local, self.tail, self.fsum,
                 self.fcnt) = _old_stream_step(*ops)
        self.base += valid
        value, f, lag = torch.stack([x.double() for x in local]).tolist()
        return float(s._freqs[int(f)]), int(lag), value


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


def _assert_same_state(s: StreamingCAF, old: _OldStream):
    assert all(_same_bits(a, b) for a, b in zip(s._best, old.best))
    assert _same_bits(s._tail, old.tail)
    assert s._base_lag == old.base
    assert s._base.dtype == torch.int32 and int(s._base) == old.base
    if s._stein:
        assert _same_bits(s._bw, old.bw)
        assert _same_bits(s._bw_start, old.bw_start)
    else:
        assert _same_bits(s._fsum, old.fsum)
        assert _same_bits(s._fcnt, old.fcnt)


def _scene(seed, cdtype, total=3000, n=256):
    """A needle and a capture over noise, made from ``seed``, with the
    two emitters that fit (the second across a chunk edge)."""
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(cdtype)
    cap = (0.05 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(cdtype)
    t = np.arange(n)
    for f, lag, amp in ((250.0, 700, 1.0), (-500.0, 2100, 0.7)):
        if lag + n <= total:
            cap[lag:lag + n] += (amp * needle * np.exp(
                2j * np.pi * f * t / FS)).astype(cdtype)
    return needle, cap


def _kw(mode):
    return {"backend": "stein" if mode.startswith("stein") else "xla",
            "num_peaks": 3 if mode.endswith("lattice") else 1,
            "chunk_len": 512}


def _chunks(cap, source):
    """The capture cut at SPLITS: numpy chunks, CPU tensors, or the two
    in turns."""
    out = []
    for i, (a, b) in enumerate(zip(SPLITS[:-1], SPLITS[1:])):
        c = cap[a:b]
        as_tensor = source == "tensor" or (source == "mixed" and i % 2)
        out.append(torch.from_numpy(c.copy()) if as_tensor else c)
    return out


# ---------------------------------------------------------------------------
# Each step against its plain version, chunk by chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("mode", MODES)
def test_step_is_the_python_int_step_bit_for_bit(mode, cdtype):
    """Every chunk's returned peak and the whole carried state (best,
    tail, floor sums or re-score windows and starts, the base lag) equal
    the old step's, bit for bit, over an oversized chunk and short ones;
    then ``best()`` / ``peaks()`` and the floor."""
    needle, cap = _scene(3, cdtype)
    s = StreamingCAF(needle, FREQS, FS, device="cpu", **_kw(mode))
    old = _OldStream(s)
    for chunk in _chunks(cap, "numpy"):
        got = s.process(chunk)
        want = old.process(chunk)
        assert got == want
        _assert_same_state(s, old)
    assert s.samples_seen == len(cap)
    if s._stein:
        assert s.noise_floor() == (s._needle_energy * old.h2
                                   / s.samples_seen)
    else:
        fsum, cnt = torch.stack([old.fsum, old.fcnt]).tolist()
        assert s.noise_floor() == fsum / cnt
    if mode.endswith("lattice"):
        fr, lg, vv = s.peaks()
        assert [(float(f), int(l)) for f, l in zip(fr[:2], lg[:2])] == [
            (250.0, 700), (-500.0, 2100)]
    else:
        assert s.best()[:2] == (250.0, 700)


@pytest.mark.parametrize("source", ["numpy", "tensor", "mixed"])
@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128])
def test_stein_model_floor_is_the_float_sum_bit_for_bit(source, cdtype):
    """The Stein model floor's energy, now an f64 tensor on the stream's
    device, sums each chunk's plane sums as the Python float did: numpy
    chunks, tensor chunks and the two in turns."""
    needle, cap = _scene(4, cdtype)
    s = StreamingCAF(needle, FREQS, FS, device="cpu", backend="stein",
                     chunk_len=512)
    old = _OldStream(s)
    assert s.noise_floor() == 0.0
    for chunk in _chunks(cap, source):
        assert s.process(chunk) == old.process(chunk)
        assert float(s._h2_sum) == old.h2
        assert s._h2_sum.dtype == torch.float64
        assert s.noise_floor() == (s._needle_energy * old.h2
                                   / s.samples_seen)


# ---------------------------------------------------------------------------
# int32 lags
# ---------------------------------------------------------------------------


def _near_int32_limit(engine, base):
    engine._base_lag = base
    if isinstance(engine, StreamingCAF):
        engine._base = torch.full((), base, dtype=torch.int32)


def test_int32_lags_wrap_and_overflow_where_jax_does():
    """A cuFFT stream whose base lag sits 300 below int32's limit: the
    chunk's lags wrap inside the step as JAX's traced int32 does (the
    same chunk peak), and the next chunk raises ``OverflowError`` in both
    packages, the state untouched."""
    needle, cap = _scene(5, np.complex64, total=1024, n=64)
    freqs = np.arange(-600.0, 600.0, 100.0, dtype=np.float32)
    port = StreamingCAF(needle, freqs, FS, device="cpu", chunk_len=512)
    jax = JaxStream(needle, freqs, FS, chunk_len=512)
    base = 2 ** 31 - 300
    for engine in (port, jax):
        _near_int32_limit(engine, base)
    got, want = port.process(cap[:512]), jax.process(cap[:512])
    assert got[:2] == want[:2] and got[1] < 0          # wrapped
    assert got[2] == pytest.approx(want[2], rel=1e-4)
    assert port._base_lag == jax._base_lag == base + 512
    assert int(port._base) == int(jnp.asarray(base + 512 - 2 ** 32))
    for engine in (port, jax):
        with pytest.raises(OverflowError):
            engine.process(cap[512:])
    assert port.samples_seen == jax.samples_seen == 512


def test_stein_stream_raises_past_int32():
    needle, cap = _scene(6, np.complex64, total=1024, n=128)
    s = StreamingCAF(needle, FREQS, FS, device="cpu", backend="stein",
                     chunk_len=512)
    _near_int32_limit(s, 2 ** 31 - 1)
    s.process(cap[:512])
    with pytest.raises(OverflowError, match="int32"):
        s.process(cap[512:])
    assert s.samples_seen == 512


# ---------------------------------------------------------------------------
# The windowed engines' per-window lag bound
# ---------------------------------------------------------------------------


def _old_bounds(total_lags, v, windows, programs):
    per_w = np.clip(total_lags - np.arange(windows) * v, 0, v)
    return torch.as_tensor(np.tile(per_w, programs), dtype=torch.int32)


@pytest.mark.parametrize("total,v,windows,programs", [
    (65536, 8192, 8, 6), (32768, 8192, 4, 16 * 6), (30001, 8192, 4, 3),
    (1, 1024, 1, 1), (5000, 1024, 7, 2), (2 ** 30 + 7, 2 ** 20, 1025, 2)])
def test_window_bounds_are_the_np_tile_bounds(total, v, windows, programs):
    got = tbs._window_bounds(total, v, windows, programs, "cpu")
    assert _same_bits(got, _old_bounds(total, v, windows, programs))


@pytest.mark.parametrize("banded", [False, True])
def test_os_operands_bound_is_the_np_tile_bound(banded):
    rng = np.random.default_rng(8)
    p, n, hay_len = 2, 256, 3000
    ns = torch.from_numpy((rng.standard_normal((p, n))
                           + 1j * rng.standard_normal((p, n))
                           ).astype(np.complex64))
    hs = torch.from_numpy((rng.standard_normal((p, hay_len))
                           + 1j * rng.standard_normal((p, hay_len))
                           ).astype(np.complex64))
    rel = torch.arange(-40.0, 40.0, 5.0)
    centers = torch.tensor([-300.0, 0.0, 300.0]) if banded else None
    v, total = 512, hay_len - n + 1
    windows = -(-total // v)
    _, _, _, modes = tbs._os_operands(pad_to(ns, 256), hs, centers, rel, FS,
                                      v, 8, windows, total)
    s = 3 if banded else 1
    assert _same_bits(modes["num_valid"], _old_bounds(total, v, windows,
                                                      p * s))
