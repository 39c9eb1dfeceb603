"""The port's fused filterbank (``pallas*`` backends, kernels K2/K3)
against the JAX package's Pallas kernels, run in interpret mode on the
CPU.  On the CPU the port's wrappers run their plain PyTorch versions;
the kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.config import CafConfig as JCafConfig
from caf_cookoff_tpu.config import FreqGrid as JFreqGrid
from caf_cookoff_tpu.models import filterbank as jfb
from caf_cookoff_tpu.ops import pallas_caf as jpc
from caf_cookoff_tpu_torch.config import CafConfig, FreqGrid
from caf_cookoff_tpu_torch.errors import EligibilityError
from caf_cookoff_tpu_torch.models import filterbank as tfb
from caf_cookoff_tpu_torch.ops import pallas_caf as tpc

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

FS = 48_000.0
# chirp_0's 24-bin grid of tests/test_pallas.py (fast to interpret).
CHIRP0_FREQS = (68.0 + 0.25 * np.arange(24)).astype(np.float32)


def _pair(seed, n, lag):
    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (np.roll(needle, lag) * np.exp(
        2j * np.pi * 1000.0 * np.arange(n) / FS)).astype(np.complex64)
    return needle, hay


def _jax_peak_rows(needle, hay, freqs, m, precision):
    rates = (2.0 * jnp.pi) * jnp.asarray(freqs, jnp.float32) / FS
    vals, idxs = jpc._pallas_peak_rows(
        jnp.asarray(needle.real), jnp.asarray(needle.imag),
        jnp.asarray(hay.real), jnp.asarray(hay.imag), rates, len(needle), m,
        interpret=True, precision=precision)
    return np.asarray(vals), np.asarray(idxs)


@pytest.fixture(scope="module")
def synthetic_rows():
    """N = 512, M = 1024, 16 bins: JAX's K2 in interpret mode at both
    tiers, and the port's plain version."""
    needle, hay = _pair(11, 512, 40)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    got = tpc.caf_peak_rows_plain(torch.from_numpy(needle),
                                  torch.from_numpy(hay), freqs, FS, 1024)
    want = {p: _jax_peak_rows(needle, hay, freqs, 1024, p)
            for p in ("high", "bf16")}
    return got, want


def test_peak_rows_plain_matches_interpret_kernel_high(synthetic_rows):
    """Plain f32 rows vs the 3-pass tier: rtol 1e-4, identical lags."""
    (vals, idxs), want = synthetic_rows
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    np.testing.assert_allclose(vals.numpy(), want["high"][0], rtol=1e-4)
    np.testing.assert_array_equal(idxs.numpy(), want["high"][1])


def test_peak_rows_plain_matches_interpret_kernel_bf16(synthetic_rows):
    """Plain f32 rows vs the single-pass bf16 tier: rtol 1e-2 (0.2%
    between the JAX tiers here), identical lags where the bf16 tier
    agrees with its own 3-pass tier."""
    (vals, idxs), want = synthetic_rows
    np.testing.assert_allclose(vals.numpy(), want["bf16"][0], rtol=1e-2)
    exact = want["bf16"][1] == want["high"][1]
    assert exact.mean() >= 0.5
    np.testing.assert_array_equal(idxs.numpy()[exact],
                                  want["bf16"][1][exact])


@pytest.fixture(scope="module")
def chirp0(fixture_pairs):
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle = load_c64(fixture_pairs[0][0])
    return needle, load_c64(fixture_pairs[0][1], count=len(needle))


@pytest.fixture(scope="module")
def jax_chirp0_peaks(chirp0):
    needle, hay = chirp0
    return {b: jfb.caf_peak(needle, hay, CHIRP0_FREQS, FS, backend=b)
            for b in ("pallas", "pallas-refine", "pallas-bf16")}


@pytest.mark.parametrize("backend", ["pallas", "pallas-refine",
                                     "pallas-bf16"])
def test_chirp0_golden_matches_jax(chirp0, jax_chirp0_peaks, backend):
    """(freq, lag) identical to the JAX package's tier and to the
    golden; the unnormalised value within rtol 1e-4 of JAX's 3-pass
    'pallas' and 1e-2 of its single-pass 'pallas-bf16'."""
    needle, hay = chirp0
    got = tfb.caf_peak(needle, hay, CHIRP0_FREQS, FS, backend=backend,
                       device="cpu")
    assert got[:2] == jax_chirp0_peaks[backend][:2] == (69.25, 202)
    assert got[2] == pytest.approx(jax_chirp0_peaks["pallas"][2], rel=1e-4)
    assert got[2] == pytest.approx(jax_chirp0_peaks["pallas-bf16"][2],
                                   rel=1e-2)
    xla = tfb.caf_peak(needle, hay, CHIRP0_FREQS, FS, backend="xla",
                       device="cpu")
    assert got[2] == pytest.approx(xla[2] * 8192.0 ** 2, rel=1e-4)


@pytest.mark.parametrize("backend,rtol", [("pallas", 1e-3),
                                          ("pallas-bf16", 1e-2)])
def test_surface_matches_jax(backend, rtol):
    """K3's surface (1/M^2 scale, natural lag order) against the JAX
    package's at rtol 1e-3 + atol 1e-4 x max (its own bound against
    the XLA surface); against its single-pass bf16 tier at rtol 1e-2
    (0.2% measured here)."""
    needle, hay = _pair(5, 512, 40)
    freqs = np.arange(-2000.0, 2000.0, 250.0, dtype=np.float32)
    want = np.asarray(jfb.caf_surface(needle, hay, freqs, FS,
                                      backend=backend))
    got = tfb.caf_surface(needle, hay, freqs, FS, backend=backend,
                          device="cpu")
    assert got.shape == want.shape == (16, 1024)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-4 * want.max())
    xla = tfb.caf_surface(needle, hay, freqs, FS, backend="xla",
                          device="cpu")
    np.testing.assert_allclose(got.numpy(), xla.numpy(), rtol=1e-4,
                               atol=1e-6 * want.max())


def test_bin_count_not_a_tile_multiple():
    """K = 5: the JAX package pads to its 8-bin tile; the port needs no
    padding and gives the same answer."""
    rng = np.random.default_rng(13)
    needle = (rng.standard_normal(256)
              + 1j * rng.standard_normal(256)).astype(np.complex64)
    hay = np.roll(needle, 7)
    freqs = np.arange(-500.0, 750.0, 250.0, dtype=np.float32)
    assert len(freqs) % tpc.TILE_BINS
    for backend in ("pallas", "pallas-refine"):
        want = jfb.caf_peak(needle, hay, freqs, FS, backend=backend)
        got = tfb.caf_peak(needle, hay, freqs, FS, backend=backend,
                           device="cpu")
        assert got[:2] == want[:2] == (0.0, 7)
        assert got[2] == pytest.approx(want[2], rel=1e-4)


def test_needle_not_a_column_multiple():
    """N = 5000 (M = 16384): the JAX package zero-pads the needle to its
    DFT column factor; the port needs no padding."""
    rng = np.random.default_rng(0)
    needle = (rng.standard_normal(5000)
              + 1j * rng.standard_normal(5000)).astype(np.complex64)
    hay = np.roll(needle, 123)
    freqs = np.arange(-100.0, 100.0, 10.0, dtype=np.float32)
    got = tfb.caf_peak(needle, hay, freqs, FS, backend="pallas",
                       device="cpu")
    assert got[:2] == (0.0, 123)
    xla = tfb.caf_peak(needle, hay, freqs, FS, backend="xla", device="cpu")
    assert got[2] == pytest.approx(xla[2] * 16384.0 ** 2, rel=1e-4)
    surf = tfb.caf_surface(needle, hay, freqs, FS, backend="pallas",
                           device="cpu")
    assert surf.shape == (20, 16384)


def test_refine_exact_tie_goes_to_lowest_bin():
    """Repeated frequencies give bit-identical rows: among the tied
    candidates the lowest bin wins, as in the JAX package."""
    rng = np.random.default_rng(2)
    needle = (rng.standard_normal(256)
              + 1j * rng.standard_normal(256)).astype(np.complex64)
    hay = np.roll(needle, 9)
    freqs = np.array([50.0, 0.0, -50.0, 0.0, 0.0, 25.0], np.float32)
    want = jpc.pallas_caf_peak(
        jnp.asarray(needle.real), jnp.asarray(needle.imag),
        jnp.asarray(hay.real), jnp.asarray(hay.imag), freqs, FS, 512,
        precision="refine")
    for precision in ("refine", "high"):
        got = tpc.pallas_caf_peak(torch.from_numpy(needle),
                                  torch.from_numpy(hay), freqs, FS, 512,
                                  precision=precision)
        assert (int(got.freq_idx), int(got.lag_idx)) == (
            int(want.freq_idx), int(want.lag_idx)) == (1, 9)


def test_filterbank_engine_object_runs_pallas(chirp0):
    needle, hay = chirp0
    grid = (68.0, 74.0, 0.25)
    want = jfb.FilterbankCAF(JCafConfig(grid=JFreqGrid(*grid),
                                        backend="pallas")).peak(needle, hay)
    got = tfb.FilterbankCAF(CafConfig(grid=FreqGrid(*grid),
                                      backend="pallas"),
                            device="cpu").peak(needle, hay)
    assert got == want == (69.25, 202)


def test_cpu_wrappers_run_plain_versions_without_launching():
    needle, hay = _pair(3, 64, 5)
    n, h = torch.from_numpy(needle), torch.from_numpy(hay)
    freqs = torch.tensor([0.0, 1000.0])
    before = (tpc.PEAK_LAUNCHES, tpc.SURFACE_LAUNCHES)
    vals, idxs = tpc.pallas_peak_rows(n, h, freqs, FS, 128)
    pv, pi = tpc.caf_peak_rows_plain(n, h, freqs, FS, 128)
    assert torch.equal(vals, pv) and torch.equal(idxs, pi)
    surf = tpc.pallas_surface(n, h, freqs, FS, 128)
    assert torch.equal(surf, tpc.caf_surface_plain(n, h, freqs, FS, 128))
    assert (tpc.PEAK_LAUNCHES, tpc.SURFACE_LAUNCHES) == before
    assert int(idxs[1]) == 5


def test_wrappers_reject_bad_inputs():
    needle, hay = _pair(3, 64, 5)
    n, h = torch.from_numpy(needle), torch.from_numpy(hay)
    with pytest.raises(EligibilityError, match="power-of-two"):
        tpc.pallas_peak_rows(n, h, [0.0], FS, 192)
    with pytest.raises(ValueError, match="too long"):
        tpc.pallas_surface(n, h, [0.0], FS, 64)
    with pytest.raises(TypeError):
        tpc.pallas_peak_rows(n.real, h, [0.0], FS, 128)
    with pytest.raises(ValueError, match="precision"):
        tpc.pallas_caf_peak(n, h, [0.0], FS, 128, precision="highest")
    with pytest.raises(ValueError, match="precision"):
        tpc.pallas_caf_surface(n, h, [0.0], FS, 128, precision="refine")


# --- The kernel's layout and dataflow (csrc/caf_filterbank.cu), in numpy.

def _dft_pass(x, log_sub, log_r, inverse, tw):
    """One decimation-in-frequency pass of the kernel (or its adjoint) on
    a (L,) complex128 row: groups of 2^log_r points at stride s inside
    segments of 2^log_sub, the DFT then the twiddles W^{jk} read from the
    pass's table ``tw`` (k-major, k >= 1; the adjoint: conjugate
    twiddles, then the inverse DFT), back in place."""
    r, s = 1 << log_r, 1 << (log_sub - log_r)
    v = x.reshape(-1, r, s)                       # [segment, i, j]
    ik = np.outer(np.arange(r), np.arange(r))
    f = np.exp(-2j * np.pi * ik / r)
    w = np.concatenate([np.ones((1, s)),
                        np.asarray(tw[:(r - 1) * s]).reshape(r - 1, s)])
    if inverse:
        return np.einsum("ki,gkj->gij", np.conj(f), v * np.conj(w)
                         ).reshape(-1)
    return (np.einsum("ki,gij->gkj", f, v) * w).reshape(-1)


def _kernel_model(needle, h_spec, rates, m, c):
    """The kernel's dataflow for one cluster size: per bin, block k1
    forms sum_{n1} s[n2 + L n1] W_M^{n k1}, runs the forward passes,
    multiplies by H read in the kernel's order (``_h_order``), runs the
    adjoint passes, multiplies by W_M^{-t k1}; then the C-point inverse
    DFT across blocks.  Returns (K, M) complex128 rows."""
    l = m // c
    t_n, log_rl, npass = tpc._block_plan(l)
    log_l = l.bit_length() - 1
    plan = [(log_l - 4 * q, 4) for q in range(npass - 1)] + [(log_rl,
                                                                log_rl)]
    # Each radix-16 pass's table: 15 s_q entries (the last pass, s = 1,
    # has none), as the kernel's tw_offset reads them.
    table, tabs, off = tpc._twiddle_table(l).astype(complex), [], 0
    for log_sub, log_r in plan[:-1]:
        tabs.append(table[off:])
        off += ((1 << log_r) - 1) << (log_sub - log_r)
    assert off == len(table)
    tabs.append(np.ones((1 << log_rl) - 1))
    h_k = h_spec[tpc._h_order(m, c)].reshape(c, l)
    q = np.arange(l)
    rl = 1 << log_rl
    pos = rl * (q % t_n + t_n * (q // t_n // rl)) + (q // t_n) % rl
    n = np.arange(len(needle))
    rows = []
    for rate in rates:
        s = needle * np.exp(1j * rate * n)
        s = np.concatenate([s, np.zeros(m - len(s))])
        blocks = []
        for k1 in range(c):
            x = (s * np.exp(-2j * np.pi * np.arange(m) * k1 / m)
                 ).reshape(c, l).sum(axis=0)
            for (log_sub, log_r), tw in zip(plan, tabs):
                x = _dft_pass(x, log_sub, log_r, False, tw)
            prod = np.empty(l, complex)
            prod[pos] = h_k[k1] * np.conj(x[pos])
            for (log_sub, log_r), tw in list(zip(plan, tabs))[::-1]:
                prod = _dft_pass(prod, log_sub, log_r, True, tw)
            blocks.append(prod * np.exp(2j * np.pi * np.arange(l) * k1 / m))
        blocks = np.array(blocks)                 # [k1, t]
        b = np.arange(c)
        r = np.exp(2j * np.pi * np.outer(b, b) / c) @ blocks   # [b, t]
        rows.append(r.reshape(-1))
    return np.array(rows)


@pytest.mark.parametrize("m,c", [(2, 1), (8, 1), (16, 1), (64, 1),
                                 (512, 1), (1024, 1), (2048, 2),
                                 (4096, 4), (8192, 1), (1024, 8),
                                 (512, 16), (32768, 4)])
def test_kernel_dataflow_matches_plain(m, c):
    """The kernel's passes, digit-reversed spectrum order, H layout,
    twiddles and cluster step (``_kernel_model``, f64) give the plain
    rows: the layout the wrapper builds is the one the passes produce.
    Rows under 32 points are one thread's single pass, H in natural
    order."""
    rng = np.random.default_rng(m + c)
    n = m // 2
    needle = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    hay = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    freqs = np.array([-700.0, 0.0, 1234.5], np.float32)
    rates = tpc._host_rates(freqs, FS).astype(np.float64)
    got = _kernel_model(needle, np.fft.fft(hay, m), rates, m, c)
    want = tpc._rows_plain(torch.from_numpy(needle.astype(np.complex64)),
                           torch.from_numpy(hay.astype(np.complex64)),
                           freqs, FS, m).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale


@pytest.mark.parametrize("m", [2, 16, 1024, 2048, 4096, 8192, 16384,
                               32768, 65536, 131072])
def test_h_layout_round_trip(m):
    """H gathered into the kernel's order (every cluster size the kernel
    takes at this M, the wrapper's among them) and scattered back equals
    torch.fft.fft of the haystack; the order is a permutation."""
    rng = np.random.default_rng(m)
    hay = torch.from_numpy((rng.standard_normal(m // 2) + 1j
                            * rng.standard_normal(m // 2)
                            ).astype(np.complex64))
    h = tpc._haystack_spectrum(hay, m)
    sizes = {c for c in (1, 2, 4, 8, 16)
             if 32 <= m // c <= tpc.BLOCK_LEN} or {1}    # M < 32: C = 1
    assert tpc.cluster_size(m) in sizes
    for c in sorted(sizes):
        order = tpc._h_order(m, c)
        assert np.array_equal(np.sort(order), np.arange(m))
        h_k = tpc._h_kernel(h, m, c)
        back = torch.empty_like(h_k)
        back[torch.from_numpy(order)] = h_k
        assert torch.equal(back, torch.fft.fft(hay, n=m))


def test_cluster_size_rule():
    """One block a bin while it holds the row (the main path's 400 x 8192
    and the refine tier's K = 8 alike), then the fewest blocks that do:
    16 at M = 131072; the card refuses past MAX_FFT_LEN."""
    assert [tpc.cluster_size(m) for m in (2, 16, 32, 1024, 8192, 16384,
                                          32768, 131072)] == [1, 1, 1, 1, 1,
                                                              2, 4, 16]
    assert tpc.MAX_FFT_LEN == 131072
    with pytest.raises(tpc.VmemBudgetError, match="131072"):
        tpc._check_card_len(262144)


def test_host_rates_match_device_formula_bit_for_bit():
    """The wrapper's host rates (numpy f32) equal ``_rates`` (torch)
    bit for bit, so the kernel's phase rate * float(n) is unchanged."""
    rng = np.random.default_rng(7)
    freqs = np.concatenate([
        np.arange(-100.0, 100.0, 0.25, dtype=np.float32),
        rng.uniform(-5000, 5000, 997).astype(np.float32),
        np.array([0.0, -0.0, 1e-3, 12345.678], np.float32)])
    for fs in (48_000.0, 44_100.0, 1e6, 3.0):
        want = tpc._rates(torch.from_numpy(freqs), fs, "cpu").numpy()
        got = tpc._host_rates(freqs, fs)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        via = tpc._kernel_rates(freqs.astype(np.float64), fs, "cpu")
        assert np.array_equal(via.numpy().view(np.int32),
                              want.view(np.int32))


def test_refine_prepares_haystack_spectrum_once(monkeypatch):
    """``pallas-refine`` computes H once for its two K2 launches, and
    answers as before."""
    calls = []
    real = tpc._haystack_spectrum

    def counted(hay, m):
        calls.append(m)
        return real(hay, m)

    monkeypatch.setattr(tpc, "_haystack_spectrum", counted)
    needle, hay = _pair(4, 512, 77)
    freqs = np.arange(-2000.0, 2000.0, 125.0, dtype=np.float32)
    got = tpc.pallas_caf_peak(torch.from_numpy(needle),
                              torch.from_numpy(hay), freqs, FS, 1024,
                              precision="refine")
    assert calls == [1024]
    vals, idxs = tpc.caf_peak_rows_plain(torch.from_numpy(needle),
                                         torch.from_numpy(hay), freqs, FS,
                                         1024)
    best = int(torch.argmax(vals))
    assert (int(got.freq_idx), int(got.lag_idx)) == (best, int(idxs[best]))
    assert float(got.value) == float(vals[best])


def test_long_needle_matches_jax_interpret():
    """A 16384-sample needle (M = 32768, past the old 16384-point limit),
    K = 8 (one JAX tile): the port's CPU ``caf_peak(backend="pallas")``
    against the JAX package's ``pallas_caf_peak`` in interpret mode,
    (freq, lag) identical, values within rtol 1e-4 (as
    ``test_chirp0_golden_matches_jax``)."""
    needle, hay = _pair(21, 16384, 5000)
    freqs = (900.0 + 25.0 * np.arange(8)).astype(np.float32)
    want = jpc.pallas_caf_peak(
        jnp.asarray(needle.real), jnp.asarray(needle.imag),
        jnp.asarray(hay.real), jnp.asarray(hay.imag), freqs, FS, 32768)
    got = tfb.caf_peak(needle, hay, freqs, FS, backend="pallas",
                       device="cpu")
    assert got[:2] == (float(freqs[int(want.freq_idx)]),
                       int(want.lag_idx)) == (1000.0, 5000)
    assert got[2] == pytest.approx(float(want.value), rel=1e-4)
