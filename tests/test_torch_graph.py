"""The compiled call (``ops/_graph``) and the Stein main path's constants
built without copies to the card, on the CPU; the static keys of the
streams' steps and the windowed engines, and their cores free of host
reads and uploads.

The static key must follow ``jax.jit``'s: each static argument, traced
shape and dtype changes it, traced values never do.  The graph cache is
a bounded LRU.  Each constant the engines now build on the device or in
numpy must be bit for bit the tensor-built expression it replaces; the
old expressions are kept here as the plain versions, on seeded grids
and sample rates (48 kHz among them), in f32 and f64.  The card's side
(captures, replays, bit-for-bit replays against the eager cores, no
syncs) is in ``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import _stein_plan as tplan
from caf_cookoff_tpu_torch.models import stein as tstein
from caf_cookoff_tpu_torch.ops import _graph
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.ops import peak as tpeak
from caf_cookoff_tpu_torch.ops import shift as tshift
from caf_cookoff_tpu_torch.ops.peak import CafPeak

FS = 48_000.0
SEEDS = [0, 1, 2]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rates(seed):
    """48 kHz, two common rates and two seeded odd ones."""
    rng = np.random.default_rng(seed)
    return [FS, 44_100.0, 96_000.0, float(rng.uniform(1e3, 2e5)),
            float(rng.uniform(7e3, 9e3)) + 0.123]


def _grid(seed, k, dtype):
    rng = np.random.default_rng(100 + seed)
    lo = rng.uniform(-2000.0, 0.0)
    step = rng.uniform(0.01, 20.0)
    g = lo + step * np.arange(k) + rng.uniform(-1e-3, 1e-3, k)
    return torch.from_numpy(g).to(dtype)


# ---------------------------------------------------------------------------
# The plain versions: the expressions as the engines built them before,
# each constant a tensor made from host data.
# ---------------------------------------------------------------------------


def _old_synthesis_weights(freqs_hz, sample_rate, num_blocks, block_len):
    f32 = torch.float32
    centers = torch.as_tensor(
        np.arange(num_blocks) * block_len + (block_len - 1) / 2.0, dtype=f32)
    scale = (torch.tensor(-2.0 * math.pi, dtype=f32)
             / torch.tensor(sample_rate, dtype=f32))
    w = scale * torch.outer(torch.as_tensor(freqs_hz, dtype=f32), centers)
    wr, wi = torch.cos(w), torch.sin(w)
    return torch.cat([wr, -wi], dim=1), torch.cat([wi, wr], dim=1)


def _old_phase_ramp(freq_hz, num_samples, sample_rate, real_dtype):
    n = torch.arange(num_samples, dtype=real_dtype)
    f = torch.as_tensor(freq_hz, dtype=real_dtype)
    fs = torch.as_tensor(sample_rate, dtype=real_dtype)
    two_pi = torch.as_tensor(2.0 * math.pi, dtype=real_dtype)
    rate = two_pi * (f / fs)
    return rate[..., None] * n if rate.ndim else rate * n


def _old_doppler_cell_bins(freqs_hz, needle_len, sample_rate):
    k = freqs_hz.shape[-1]
    step = torch.clamp((freqs_hz[min(1, k - 1)] - freqs_hz[0]).abs(),
                       min=1e-30)
    cell = torch.as_tensor(sample_rate, dtype=freqs_hz.dtype) / needle_len
    return torch.clamp(torch.ceil(cell / step), 1.0,
                       float(k)).to(torch.int32)


def _old_shift_to_centers(ns_re, ns_im, centers, sample_rate):
    p, n = ns_re.shape
    s = centers.shape[0]
    dt = ns_re.dtype
    t = torch.arange(n, dtype=dt)
    scale = (torch.tensor(2.0 * math.pi, dtype=dt)
             / torch.tensor(sample_rate, dtype=dt))
    ph = (scale * centers.to(dt)[None, :, None]) * t[None, None, :]
    cs, sn = torch.cos(ph), torch.sin(ph)
    sr = (ns_re[:, None, :] * cs - ns_im[:, None, :] * sn).reshape(p * s, n)
    si = (ns_re[:, None, :] * sn + ns_im[:, None, :] * cs).reshape(p * s, n)
    n_pad = n + (-n) % tfs.SUPER
    return (torch.nn.functional.pad(sr, (0, n_pad - n)),
            torch.nn.functional.pad(si, (0, n_pad - n)))


def _old_doppler_synthesis(g, freqs_hz, sample_rate, block_len):
    gr, gi = g.real, g.imag
    b = gr.shape[0]
    rdtype = gr.dtype
    centers = torch.as_tensor(
        np.arange(b) * block_len + (block_len - 1) / 2.0, dtype=rdtype)
    scale = (torch.tensor(-2.0 * math.pi, dtype=rdtype)
             / torch.tensor(sample_rate, dtype=rdtype))
    w = scale * torch.outer(freqs_hz.to(rdtype), centers)
    wr, wi = torch.cos(w), torch.sin(w)
    ws = torch.cat([torch.cat([wr, -wi], dim=1),
                    torch.cat([wi, wr], dim=1)], dim=0)
    rs = ws @ torch.cat([gr, gi], dim=0)
    k = wr.shape[0]
    return rs[:k], rs[k:]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# Constants, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("b,d", [(64, 64), (32, 128), (512, 8), (7, 5)])
def test_synthesis_weights_bit_for_bit(seed, dtype, b, d):
    freqs = _grid(seed, 37, dtype)
    for fs in _rates(seed):
        got = tfs.stein_synthesis_weights(freqs, fs, b, d)
        want = _old_synthesis_weights(freqs, fs, b, d)
        assert all(_same_bits(g, w) for g, w in zip(got, want)), fs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_phase_ramp_bit_for_bit(seed, dtype):
    """A tensor grid, a host grid, a host scalar and a 0-d tensor."""
    freqs = _grid(seed, 19, dtype)
    for fs in _rates(seed):
        for f in (freqs, freqs.numpy(), float(freqs[3]), freqs[5]):
            got = tshift._phase_ramp(f, 333, fs, dtype, "cpu")
            want = _old_phase_ramp(f, 333, fs, dtype)
            assert _same_bits(got, want), (fs, type(f))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_doppler_cell_bins_bit_for_bit(seed, dtype):
    """Needle lengths a power of two and not; steps that put fs/N near
    a whole number of bins; a grid of one bin."""
    rng = np.random.default_rng(seed)
    for fs in _rates(seed):
        for n in (4096, 1000, 2755, int(rng.integers(64, 70000))):
            cell = fs / n
            for step in (cell / 3.0, cell / 7.0, cell * 2.5,
                         float(rng.uniform(0.01, 50.0))):
                freqs = (torch.arange(50, dtype=torch.float64) * step
                         - 10.0).to(dtype)
                for grid in (freqs, freqs[:1]):
                    got = tpeak.doppler_cell_bins(grid, n, fs)
                    want = _old_doppler_cell_bins(grid, n, fs)
                    assert _same_bits(got, want), (fs, n, step)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_shift_to_centers_bit_for_bit(seed, dtype):
    rng = np.random.default_rng(seed)
    nr = torch.from_numpy(rng.standard_normal((2, 300))).to(dtype)
    ni = torch.from_numpy(rng.standard_normal((2, 300))).to(dtype)
    centers = torch.from_numpy(rng.uniform(-1500.0, 1500.0, 5)).to(
        torch.float32)
    for fs in _rates(seed):
        got = tbs._shift_to_centers(nr, ni, centers, fs)
        want = _old_shift_to_centers(nr, ni, centers, fs)
        assert all(_same_bits(g, w) for g, w in zip(got, want)), fs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_doppler_synthesis_bit_for_bit(seed, dtype):
    """The unfused rows' synthesis weights (block centres and -2 pi/fs
    in the rows' dtype)."""
    rng = np.random.default_rng(seed)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    g = torch.complex(torch.from_numpy(rng.standard_normal((16, 64))),
                      torch.from_numpy(rng.standard_normal((16, 64)))
                      ).to(cdt)
    freqs = _grid(seed, 11, dtype)
    for fs in _rates(seed):
        got = tstein._doppler_synthesis(g, freqs, fs, 64)
        want = _old_doppler_synthesis(g, freqs, fs, 64)
        assert all(_same_bits(a, b) for a, b in zip(got, want)), fs


# ---------------------------------------------------------------------------
# The static key and the cache
# ---------------------------------------------------------------------------


def _core(a, b, c, fs, xl, block_len, refine, fused):
    return a


def _traced(seed=0, n=64, k=10, cdt=torch.complex64, rdt=torch.float32):
    rng = np.random.default_rng(seed)
    a = torch.complex(torch.from_numpy(rng.standard_normal(n)),
                      torch.from_numpy(rng.standard_normal(n))).to(cdt)
    c = torch.from_numpy(rng.standard_normal(k)).to(rdt)
    return (a, a.clone(), c)


STATIC = (FS, 128, 64, True, True)


def test_static_key_ignores_traced_values():
    assert (_graph.static_key(_core, _traced(0), STATIC)
            == _graph.static_key(_core, _traced(1), STATIC))


@pytest.mark.parametrize("i,value", [(0, 44_100.0), (1, 256), (2, 32),
                                     (3, False), (4, False)])
def test_static_key_follows_each_static_argument(i, value):
    static = list(STATIC)
    static[i] = value
    assert (_graph.static_key(_core, _traced(), STATIC)
            != _graph.static_key(_core, _traced(), tuple(static)))


@pytest.mark.parametrize("kw", [{"n": 65}, {"k": 11},
                                {"cdt": torch.complex128},
                                {"rdt": torch.float64}])
def test_static_key_follows_shapes_and_dtypes(kw):
    assert (_graph.static_key(_core, _traced(), STATIC)
            != _graph.static_key(_core, _traced(**kw), STATIC))


def test_static_key_follows_the_core():
    other = tstein._stein_core
    assert (_graph.static_key(_core, _traced(), STATIC)
            != _graph.static_key(other, _traced(), STATIC))


def test_graph_cache_evicts_least_recently_used_first():
    cache = _graph.GraphCache(3)
    for key in "abc":
        cache.put(key, key.upper())
    assert cache.get("a") == "A"          # a use: b is now the oldest
    cache.put("d", "D")
    assert [k for k, _ in cache.items()] == ["c", "a", "d"]
    assert cache.get("b") is None
    cache.put("c", "C2")                  # a put refreshes too
    cache.put("e", "E")
    assert [k for k, _ in cache.items()] == ["d", "c", "e"]
    assert len(cache) == 3
    assert cache.get("c") == "C2"


def test_cpu_calls_run_the_core_and_capture_nothing():
    calls = []

    def core(x, scale):
        calls.append(scale)
        return x * scale

    before = _graph.CAPTURES, _graph.REPLAYS
    x = torch.arange(4.0)
    assert torch.equal(_graph.compiled(core, (x,), (2.0,)), x * 2.0)
    assert calls == [2.0]
    assert (_graph.CAPTURES, _graph.REPLAYS) == before
    assert torch.device("cpu") not in _graph._CACHES


# ---------------------------------------------------------------------------
# The packed answer and the entry points' plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vdt", DTYPES)
def test_packed_answer_reads_back_exactly(vdt):
    rng = np.random.default_rng(4)
    value = torch.from_numpy(rng.standard_normal((3, 5)) * 1e30).to(vdt)
    value[0, 0] = -math.inf
    idx = torch.tensor([[0, 1, 2**31 - 1, 7, 2**24 + 1]] * 3,
                       dtype=torch.int32)
    lag = idx.flip(-1)
    packed = tplan._pack(CafPeak(value, idx, lag))
    assert packed.shape == (3, 3, 5) and packed.dtype == torch.float64
    assert torch.equal(packed[1].to(torch.int32), idx)
    grid = np.arange(8, dtype=np.float32)
    small = CafPeak(value, idx % 8, lag)
    f, lg, v = tplan._host(grid, small)
    assert np.array_equal(f, grid[(idx % 8).numpy()])
    assert lg.dtype == np.int32 and np.array_equal(lg, lag.numpy())
    assert v.dtype == value.numpy().dtype
    assert np.array_equal(v, value.numpy())
    for got, want in zip(tplan._host(grid, tplan._pack(small), vdt),
                         (f, lg, v)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _pair(n=512, lag=37, f_hz=12.5, seed=3):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.roll(needle, lag) * np.exp(
        2j * np.pi * f_hz * np.arange(n) / FS).astype(np.complex64)
    return needle, hay.astype(np.complex64)


def test_stein_plans_key_as_jax_jits():
    """``stein_caf_peak``'s compiled call: the single-program core with
    (fs, xcor_len, block_len, refine, fused) static, or the banded core
    with the band plan's shape; its CPU answer is the eager core's."""
    needle, hay = _pair()
    freqs = np.arange(-100.0, 100.0, 2.5, dtype=np.float32)
    core, traced, static, grid, vdt = tstein._stein_call(
        needle, hay, freqs, FS, 64, True, None, "cpu")
    assert core is tstein._stein_core and vdt == torch.float32
    assert static == (FS, 1024, 64, True, False)     # fused only off the CPU
    assert [t.shape for t in traced] == [(512,), (512,), (80,)]
    assert np.array_equal(grid, freqs)
    packed = core(*traced, *static)
    got = tstein.stein_caf_peak(needle, hay, freqs, FS, device="cpu")
    assert got == (float(freqs[int(packed[1])]), int(packed[2]),
                   float(packed[0]))
    assert got[:2] == (12.5, 37)
    wide = np.arange(-3000.0, 3000.0, 50.0, dtype=np.float32)   # banded
    core, traced, static, grid, _ = tstein._stein_call(
        needle, hay, wide, FS, 64, True, None, "cpu")
    plan = tplan._plan_bands(FS, wide)
    assert core is tbs._banded_core
    assert static == (FS, 1024, plan["block_len"], len(wide))
    assert [tuple(t.shape) for t in traced] == [
        (1, 512), (1, 512), (plan["bands"] * plan["kb"],),
        (plan["bands"],), (plan["kb"],)]
    assert np.array_equal(grid, plan["freqs_pad"])
    packed = core(*traced, *static)[:, 0]
    assert tstein.stein_caf_peak(needle, hay, wide, FS, device="cpu") == (
        float(grid[int(packed[1])]), int(packed[2]), float(packed[0]))


def test_batched_plans_key_as_jax_jits():
    needle, hay = _pair()
    needles = np.stack([needle, np.roll(needle, 3)])
    hays = np.stack([hay, np.roll(hay, 3)])
    freqs = np.arange(-100.0, 100.0, 2.5, dtype=np.float32)
    core, traced, static, grid, vdt = tbs._batched_call(
        needles, hays, freqs, FS, 64, True, "cpu")
    assert core is tbs._batched_core and static == (FS, 1024, 64, True)
    assert vdt == torch.float32
    fr, lg, vv = tbs.batched_stein_peak(needles, hays, freqs, FS,
                                        device="cpu")
    packed = core(*traced, *static)
    assert np.array_equal(fr, freqs[packed[1].long().numpy()])
    assert np.array_equal(lg, packed[2].numpy().astype(np.int32))
    assert np.array_equal(vv, packed[0].numpy().astype(np.float32))
    _, _, static, _, vdt = tbs._batched_call(
        needles, hays, freqs, FS, 64, False, "cpu")
    assert static == (FS, 1024, 64, False) and vdt == torch.float32
    wide = np.arange(-3000.0, 3000.0, 50.0, dtype=np.float32)   # banded
    core, traced, static, grid, _ = tbs._batched_call(
        needles, hays, wide, FS, 64, True, "cpu")
    assert core is tbs._banded_core and len(traced) == 5


def test_grid_tensor_on_the_device_is_used_as_given():
    needle, hay = _pair()
    grid = torch.arange(-100.0, 100.0, 2.5)
    _, traced, _, host, _ = tstein._stein_call(needle, hay, grid, FS, 64,
                                               True, None, "cpu")
    assert traced[2].data_ptr() == grid.data_ptr()    # no copy
    assert np.array_equal(host, grid.numpy())
    _, traced, _, _, _ = tstein._stein_call(needle, hay, grid.double(), FS,
                                            64, True, None, "cpu")
    assert traced[2].dtype == torch.float32
    assert torch.equal(traced[2], grid)


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value back to the host (on a
    card each is a stream sync, and a CUDA graph cannot capture it)."""

    READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
             "_unique2", "unique_consecutive"}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.READS:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_the_cores_read_nothing_back():
    """Each compiled core — the single program (fused and not), the
    banded path, the batch and the banded batch — runs without a host
    read, as its capture on a card needs."""
    needle, hay = _pair(n=1024)
    grid = np.arange(-100.0, 100.0, 2.5, dtype=np.float32)
    wide = np.arange(-3000.0, 3000.0, 50.0, dtype=np.float32)
    calls = [tstein._stein_call(needle, hay, g, FS, 64, True, fused, "cpu")
             for g, fused in ((grid, True), (grid, False), (wide, None))]
    pairs = (np.stack([needle, hay]), np.stack([hay, needle]))
    calls += [tbs._batched_call(*pairs, g, FS, 64, True, "cpu")
              for g in (grid, wide)]
    assert [c[0] for c in calls] == [tstein._stein_core, tstein._stein_core,
                                     tbs._banded_core, tbs._batched_core,
                                     tbs._banded_core]
    for core, traced, static, *_ in calls:
        with _HostReads() as mode:
            core(*traced, *static)
        assert mode.reads == [], (core.__name__, static)
    with _HostReads() as mode:
        torch.arange(3.0)[torch.tensor(1)]    # a 0-d index reads it back
    assert mode.reads


# ---------------------------------------------------------------------------
# The streams and the windowed engines
# ---------------------------------------------------------------------------


STREAM_FREQS = np.arange(-1000.0, 1000.0, 125.0, dtype=np.float32)
STREAM_SPLITS = [0, 512, 900, 2200, 2601, 3000]   # short and oversized
STREAM_MODES = {"cufft": {}, "cufft_lattice": {"num_peaks": 3},
                "stein": {"backend": "stein"},
                "stein_lattice": {"backend": "stein", "num_peaks": 3}}


@pytest.fixture
def recorded(monkeypatch):
    """Every compiled call made, as ``(core, traced, static)``."""
    calls = []
    compiled = _graph.compiled

    def record(core, traced, static=(), **kw):
        calls.append((core, tuple(traced), tuple(static)))
        return compiled(core, traced, static, **kw)

    monkeypatch.setattr(_graph, "compiled", record)
    return calls


def _stream_run(mode, seed=0, n=256, cdt=np.complex64, freqs=STREAM_FREQS,
                **kw):
    """A stream over a seeded capture cut at STREAM_SPLITS, then its
    best() or peaks()."""
    from caf_cookoff_tpu_torch import StreamingCAF

    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        cdt)
    cap = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
           ).astype(cdt)
    cap[700:700 + n] += needle
    opts = {"chunk_len": 512, **STREAM_MODES[mode], **kw}
    s = StreamingCAF(needle, freqs, FS, device="cpu", **opts)
    for a, b in zip(STREAM_SPLITS[:-1], STREAM_SPLITS[1:]):
        s.process(cap[a:b])
    s.peaks() if s._num_peaks > 1 else s.best()
    return s


def _keys(calls, core):
    return [_graph.static_key(c, t, st) for c, t, st in calls if c is core]


STEPS = {"cufft": "_stream_step", "cufft_lattice": "_stream_lattice_step",
         "stein": "_stein_stream_step",
         "stein_lattice": "_stein_stream_lattice_step"}


@pytest.mark.parametrize("mode", list(STREAM_MODES))
def test_stream_step_keys_as_jax_jits(recorded, mode):
    """One key serves every chunk of a stream — full, short (padded to
    the pinned length) and the slices of an oversized one — and another
    stream of the same shapes (other needle, capture and grid values);
    the key follows chunk_len, num_peaks, the exclusions, the needle
    length and the dtype, as JAX's ``static_argnames`` and shapes do."""
    from caf_cookoff_tpu_torch.models import streaming as tst

    core = getattr(tst, STEPS[mode])
    _stream_run(mode)
    keys = _keys(recorded, core)
    assert len(keys) == 7 and len(set(keys)) == 1       # 5 chunks, 7 steps
    recorded.clear()
    _stream_run(mode, seed=1, freqs=STREAM_FREQS + np.float32(3.0))
    assert set(_keys(recorded, core)) == set(keys)
    variants = [{"chunk_len": 256}, {"n": 200},
                {"cdt": np.complex128}]
    if "lattice" in mode:
        variants += [{"num_peaks": 2}, {"exclude_freq": 1, "exclude_lag": 9}]
    for kw in variants:
        recorded.clear()
        _stream_run(mode, **kw)
        other = set(_keys(recorded, core))
        assert len(other) == 1 and not other & set(keys), kw


@pytest.mark.parametrize("mode", ["stein", "stein_lattice", "cufft"])
def test_stream_rescore_and_spectra_key_on_shapes_only(recorded, mode):
    """``best()`` / ``peaks()``' exact re-score keys on (xl, max_lag,
    win) and shapes, never on the carried state; the cuFFT stream's
    needle spectra on (fs, fft_len) and shapes."""
    from caf_cookoff_tpu_torch.models import overlap_save as tos
    from caf_cookoff_tpu_torch.models import streaming as tst

    s = _stream_run(mode)
    core = tst._stein_lattice_rescore if mode != "cufft" else \
        tos.needle_spectra_conj
    keys = _keys(recorded, core)
    assert len(keys) == 1
    recorded.clear()
    _stream_run(mode, seed=2, freqs=STREAM_FREQS - np.float32(7.0))
    assert _keys(recorded, core) == keys
    static = keys[0][3]
    if mode == "cufft":
        assert static == (FS, 512)
    else:
        assert static == (FS, 512, s._needle_pad + tst._RESCORE_PAD - 256,
                          s._rescore_win)
        assert [shape for shape, _ in keys[0][2]][1] == (
            s._num_peaks if s._num_peaks > 1 else 1, s._carry)


def _os_inputs(n=256, hay=3000, p=2, seed=5):
    rng = np.random.default_rng(seed)
    ns = (rng.standard_normal((p, n))
          + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hs = (1e-2 * (rng.standard_normal((p, hay))
                  + 1j * rng.standard_normal((p, hay)))).astype(np.complex64)
    hs[:, 1500:1500 + n] += ns
    return ns, hs


def test_os_plans_key_as_jax_jits():
    """``batched_stein_os_peak``'s compiled call: the windowed core with
    (fs, xcor_len, block_len, windows, total_lags, needle_len) static, or
    the banded core with num_bins too (JAX's ``_batched_stein_os_jit`` /
    ``_banded_stein_os_jit``); its CPU answer is the eager core's."""
    ns, hs = _os_inputs()
    freqs = np.arange(-100.0, 100.0, 12.5, dtype=np.float32)
    core, traced, static, grid, vdt = tbs._os_call(ns, hs, freqs, FS, None,
                                                   64, "cpu")
    assert core is tbs._os_core and vdt == torch.float32
    total = 3000 - 256 + 1
    assert static[:2] == (FS, 512) and static[3:] == (-(-total // 512),
                                                      total, 256)
    assert [tuple(t.shape) for t in traced] == [(2, 256), (2, 3000), (16,)]
    fr, lg, vv = tbs.batched_stein_os_peak(ns, hs, freqs, FS, device="cpu")
    for got, want in zip(tplan._host(grid, core(*traced, *static), vdt),
                         (fr, lg, vv)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert lg.tolist() == [1500, 1500]
    _, _, static2, _, _ = tbs._os_call(ns, hs, freqs, FS, 2000, 64, "cpu")
    assert static2[3:5] == (4, 2000)
    wide = np.arange(-3000.0, 3000.0, 25.0, dtype=np.float32)
    core, traced, static, grid, _ = tbs._os_call(ns, hs, wide, FS, None, 64,
                                                 "cpu")
    assert core is tbs._banded_os_core and static[-1] == len(wide)
    assert len(traced) == 5 and np.array_equal(grid, traced[2].numpy())
    fr, lg, vv = tbs.batched_stein_os_peak(ns, hs, wide, FS, device="cpu")
    assert np.array_equal(fr, tplan._host(grid, core(*traced, *static))[0])


def test_os_key_ignores_values():
    freqs = np.arange(-100.0, 100.0, 12.5, dtype=np.float32)
    a = tbs._os_call(*_os_inputs(seed=1), freqs, FS, None, 64, "cpu")
    b = tbs._os_call(*_os_inputs(seed=2), freqs + np.float32(1.0), FS, None,
                     64, "cpu")
    assert _graph.static_key(*a[:3]) == _graph.static_key(*b[:3])


class _Uploads(_HostReads):
    """Also records tensors made from host data (``torch.tensor``,
    ``torch.as_tensor`` of numpy): on a card each is a copy to it."""

    def __init__(self):
        super().__init__()
        self.uploads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] == "lift_fresh":
            self.uploads.append(func.__name__)
        return super().__torch_dispatch__(func, types, args, kwargs)


def test_the_stream_and_windowed_cores_read_and_upload_nothing(recorded):
    """Each new compiled core — the four steps, the re-score, the needle
    spectra and the two windowed cores — runs without a host read and
    without a tensor made from host data, as its capture needs."""
    for mode in STREAM_MODES:
        _stream_run(mode)
    ns, hs = _os_inputs()
    grids = (np.arange(-100.0, 100.0, 12.5, dtype=np.float32),
             np.arange(-3000.0, 3000.0, 25.0, dtype=np.float32))
    calls = [tbs._os_call(ns, hs, g, FS, None, 64, "cpu")[:3] for g in grids]
    seen = {}
    for core, traced, static in recorded + calls:
        seen.setdefault(core.__name__, (core, traced, static))
    assert sorted(seen) == sorted([
        "_stream_step", "_stream_lattice_step", "_stein_stream_step",
        "_stein_stream_lattice_step", "_stein_lattice_rescore",
        "needle_spectra_conj", "_os_core", "_banded_os_core"])
    for name, (core, traced, static) in seen.items():
        with _Uploads() as mode:
            core(*traced, *static)
        assert mode.reads == [] and mode.uploads == [], name
    with _Uploads() as mode:
        torch.as_tensor(np.arange(3), dtype=torch.int32)
    assert mode.uploads
