"""Fused Stein coarse rank: the port's operand constructors and plain
version against the JAX package.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas kernel in interpret mode and its XLA twin ``_coarse_rank_xla``.
Operands built by the JAX package are carried into tensors with
``utils/convert``.  The CUDA kernel itself is held to the error bound of
``rank_bound_check`` on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); the bound itself is tested here.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caf_cookoff_tpu.models import batched_stein as jbs
from caf_cookoff_tpu.ops import pallas_stein as jps
from caf_cookoff_tpu.ops.splitfft import split_array
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.ops import fused_stein as tfs
from caf_cookoff_tpu_torch.utils.convert import stein_operands_from_numpy

torch.set_num_threads(1)

FS = 48_000.0


def _pairs(rng, p, n, hay_len=None):
    shape = (p, hay_len or n)
    needles = (rng.standard_normal((p, n))
               + 1j * rng.standard_normal((p, n))).astype(np.complex64)
    hays = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return needles, hays


def _jax_operands(needles, hays, freqs, m, d):
    """(ws1, ws2, lmat, h_ext, b, sup) built by the JAX package."""
    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    hs_re, hs_im = map(jnp.asarray, split_array(hays))
    b = ns_re.shape[-1] // d
    lmat, sup = jbs._needle_operator(ns_re, ns_im, d)
    span = jps.fused_span(b, sup, m)
    h_ext = jbs._haystack_extension(hs_re, hs_im, m, span)
    ws1, ws2 = jps.stein_synthesis_weights(jnp.asarray(freqs), FS, b, d)
    return ws1, ws2, lmat, h_ext, b, sup


def _kernel_vs_plain(needles, hays, freqs, m, d):
    """JAX's Pallas kernel (interpret mode) and the port's plain version
    with the kernel's bf16 roundings, on the same operands:
    numpy (kv, ki, pv, pi), each (K, P)."""
    ws1, ws2, lmat, h_ext, b, sup = _jax_operands(needles, hays, freqs, m, d)
    kv, ki = jps.fused_stein_rank(ws1, ws2, lmat, h_ext, b, sup, m,
                                  interpret=True)
    ops = stein_operands_from_numpy(ws1, ws2, lmat, h_ext, device="cpu")
    pv, pi = tfs.coarse_rank_plain(*ops, b, sup, m, emulate_bf16=True)
    return (np.asarray(kv), np.asarray(ki), pv.numpy(), pi.numpy())


def test_needle_operator_and_extension_bit_exact():
    rng = np.random.default_rng(0)
    needles, hays = _pairs(rng, 2, 512, hay_len=500)
    m, d = 1024, 64
    ns_re, ns_im = split_array(needles)
    hs_re, hs_im = split_array(hays)
    jl, jsup = jbs._needle_operator(jnp.asarray(ns_re), jnp.asarray(ns_im), d)
    tl, tsup = tbs._needle_operator(torch.from_numpy(ns_re),
                                    torch.from_numpy(ns_im), d)
    assert jsup == tsup == d
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    span = jps.fused_span(512 // d, d, m)
    assert tfs.fused_span(512 // d, d, m) == span
    jh = jbs._haystack_extension(jnp.asarray(hs_re), jnp.asarray(hs_im), m,
                                 span)
    th = tbs._haystack_extension(torch.from_numpy(hs_re),
                                 torch.from_numpy(hs_im), m, span)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_synthesis_weights_match_jax():
    freqs = np.arange(-100.0, 100.0, 0.5, dtype=np.float32)
    jw1, jw2 = jps.stein_synthesis_weights(jnp.asarray(freqs), FS, 64, 64)
    tw1, tw2 = tfs.stein_synthesis_weights(torch.from_numpy(freqs), FS, 64,
                                           64)
    # Same f32 phases; the two CPU cos/sin implementations may differ
    # in the last bit of the result.
    np.testing.assert_allclose(tw1.numpy(), np.asarray(jw1), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tw2.numpy(), np.asarray(jw2), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("p,n,d,k,m", [(2, 512, 64, 16, 1024),
                                       (1, 1024, 32, 40, 2048)])
def test_plain_matches_xla_twin_f32(p, n, d, k, m):
    """The plain version in f32 against JAX's ``_coarse_rank_xla`` on
    operands carried across: identical lags; values to 1e-4 (f32 sums
    taken in another order)."""
    rng = np.random.default_rng(1)
    needles, hays = _pairs(rng, p, n)
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    ws1, ws2, lmat, h_ext, b, sup = _jax_operands(needles, hays, freqs, m, d)
    xv, xi = jbs._coarse_rank_xla(ws1, ws2, lmat, h_ext, b, sup, m)
    ops = stein_operands_from_numpy(ws1, ws2, lmat, h_ext, device="cpu")
    pv, pi = tfs.coarse_rank_plain(*ops, b, sup, m)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))
    np.testing.assert_allclose(pv.numpy(), np.asarray(xv), rtol=1e-4)


@pytest.mark.parametrize("p,n,d,k,m", [(2, 512, 64, 16, 1024),
                                       (2, 256, 64, 9, 512)])
def test_plain_bf16_matches_pallas_kernel(p, n, d, k, m):
    """The plain version with the kernel's bf16 roundings against the
    Pallas kernel in interpret mode, at the shapes of the JAX package's
    kernel tests: identical lags, values within the 2e-2 that the JAX
    package's own kernel-vs-twin test allows (bf16 products summed in
    another order)."""
    rng = np.random.default_rng(6)
    needles, hays = _pairs(rng, p, n)
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    kv, ki, pv, pi = _kernel_vs_plain(needles, hays, freqs, m, d)
    np.testing.assert_array_equal(pi, ki)
    np.testing.assert_allclose(pv, kv, rtol=2e-2)


def test_cross_tile_tie_break_lowest_lag():
    """Two bit-identical copies of the needle at lags 100 and 3172 (lag
    tiles 0 and 6 of the Pallas kernel) tie exactly; the lowest lag
    wins, as in the kernel."""
    rng = np.random.default_rng(11)
    n, d, k, m = 512, 64, 17, 4096
    lag_a, lag_b = 100, 6 * 512 + 100
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = np.zeros(lag_b + n, np.complex64)
    hay[lag_a:lag_a + n] = needle
    hay[lag_b:lag_b + n] = needle
    freqs = np.linspace(-100, 100, k).astype(np.float32)
    _, ki, _, pi = _kernel_vs_plain(needle[None], hay[None], freqs, m, d)
    assert pi[k // 2, 0] == ki[k // 2, 0] == lag_a
    np.testing.assert_array_equal(pi, ki)


def test_static_tail_mask():
    """num_lags below the 512 lag quantum (N=128 -> M=256): lags past
    num_lags read -1.0 and never win."""
    rng = np.random.default_rng(13)
    p, n, d, k, m = 2, 128, 32, 9, 256
    needles, hays = _pairs(rng, p, n)
    freqs = np.linspace(-50, 50, k).astype(np.float32)
    kv, ki, pv, pi = _kernel_vs_plain(needles, hays, freqs, m, d)
    assert int(pi.max()) < m
    np.testing.assert_array_equal(pi, ki)
    np.testing.assert_allclose(pv, kv, rtol=2e-2)


def test_wrapper_cpu_route_counts_no_launch():
    """CPU tensors take the plain version (bf16 roundings), leave the
    launch count alone, and zero the lags under ``want_idxs=False``."""
    rng = np.random.default_rng(2)
    needles, hays = _pairs(rng, 1, 512)
    freqs = np.linspace(-100, 100, 16).astype(np.float32)
    ws1, ws2, lmat, h_ext, b, sup = _jax_operands(needles, hays, freqs,
                                                  1024, 64)
    ops = stein_operands_from_numpy(ws1, ws2, lmat, h_ext, device="cpu")
    before = tfs.LAUNCHES
    v, i = tfs.fused_stein_rank(*ops, b, sup, 1024)
    pv, pi = tfs.coarse_rank_plain(*ops, b, sup, 1024, emulate_bf16=True)
    torch.testing.assert_close(v, pv, rtol=0, atol=0)
    torch.testing.assert_close(i, pi, rtol=0, atol=0)
    _, i0 = tfs.fused_stein_rank(*ops, b, sup, 1024, want_idxs=False)
    assert int(i0.abs().sum()) == 0
    # Mode (e): four (K, P) fields, slot 1 the plain rank's; a sep that
    # covers every lag leaves slot 2 at its (-1.0, 0) sentinel.
    top2 = tfs.fused_stein_rank(*ops, b, sup, 1024, want_top2=True, sep=4)
    assert [tuple(t.shape) for t in top2] == [(16, 1)] * 4
    assert [t.dtype for t in top2] == [torch.float32, torch.int32] * 2
    torch.testing.assert_close(top2[0], pv, rtol=0, atol=0)
    torch.testing.assert_close(top2[1], pi, rtol=0, atol=0)
    assert bool((top2[2] <= top2[0]).all())
    assert bool(((top2[3] - top2[1]).abs() > 4).all())
    _, _, v2, i2 = tfs.fused_stein_rank(*ops, b, sup, 1024, want_top2=True,
                                        sep=1024)
    assert v2.eq(-1.0).all() and i2.eq(0).all()
    assert tfs.LAUNCHES == before
    with pytest.raises(ValueError, match="h_ext"):
        tfs.fused_stein_rank(*ops[:3], ops[3][..., :-1], b, sup, 1024)
    with pytest.raises(ValueError, match="windows"):
        tfs.fused_stein_rank(*ops, b, sup, 1024, windows=2)
    with pytest.raises(ValueError, match="num_valid"):
        tfs.fused_stein_rank(*ops, b, sup, 1024, num_valid=[5, 5])


def test_import_needs_no_toolchain():
    """Importing the kernel module (and the package) builds nothing and
    imports neither triton nor JAX."""
    code = ("import sys; import caf_cookoff_tpu_torch.ops.fused_stein, "
            "caf_cookoff_tpu_torch; "
            "bad = [m for m in ('triton', 'jax', 'caf_cookoff_tpu') "
            "if m in sys.modules]; "
            "from caf_cookoff_tpu_torch.ops import _build; "
            "assert _build._LIB is None; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]"


def _modes_operands(p, s, w, n, d, k, v, planted):
    """JAX-built operands of K1's composed modes: lmat per (pair, band),
    h_ext per (pair, window) (linear window slices), and the per-window
    lag bound of a capture whose last window ends 300 lags short.
    ``planted``: impulse needles and isolated spikes (bf16-proof lags,
    the stronger spike past the short window's bound); else noise."""
    total = w * v - 300
    if planted:
        needles = np.zeros((p * s, n), np.complex64)
        for j in range(p * s):
            needles[j, 7 * j] = 1.0
        hays = np.zeros((p, total + n), np.complex64)
        for pair in range(p):
            for win in range(w):
                hays[pair, win * v + 101 + 13 * pair + 29 * win] = 2.0
                hays[pair, win * v + 903 + 17 * pair] = 3.0 if win else 1.0
    else:
        rng = np.random.default_rng(p * 100 + s * 10 + w)
        needles, hays = _pairs(rng, p * s, n, hay_len=total + n)
        hays = hays[:p]
    ns_re, ns_im = map(jnp.asarray, split_array(needles))
    hs_re, hs_im = map(jnp.asarray, split_array(hays))
    b = n // d
    lmat, sup = jbs._needle_operator(ns_re, ns_im, d)
    h_ext = jbs._os_window_extensions(hs_re, hs_im, v, w,
                                      jps.fused_span(b, sup, v))
    ws1, ws2 = jps.stein_synthesis_weights(
        jnp.asarray(np.linspace(-100, 100, k).astype(np.float32)), FS, b, d)
    per_w = np.clip(total - np.arange(w) * v, 0, v)
    num_valid = np.tile(per_w, p * s).astype(np.int32) if w > 1 else None
    return (ws1, ws2, lmat, h_ext), b, sup, num_valid


MODES = [(3, 1), (1, 3), (3, 2)]   # (share_h, windows): (c), (d), (c+d)


@pytest.mark.parametrize("s,w", MODES)
def test_plain_modes_bf16_match_pallas_kernel(s, w):
    """The plain version in modes (c), (d) and (c+d), with the kernel's
    bf16 roundings and index maps, against JAX's Pallas kernel in
    interpret mode: planted structure (emitters in different bands and
    windows), identical lags, values within the JAX package's 2e-2."""
    p, n, d, k, v = 2, 512, 64, 16, 1024
    ops, b, sup, nv = _modes_operands(p, s, w, n, d, k, v, planted=True)
    kv, ki = jps.fused_stein_rank(*ops, b, sup, v, interpret=True,
                                  windows=w, share_h=s,
                                  num_valid=None if nv is None
                                  else jnp.asarray(nv))
    tops = stein_operands_from_numpy(*ops, device="cpu")
    pv, pi = tfs.fused_stein_rank(*tops, b, sup, v, windows=w, share_h=s,
                                  num_valid=nv)
    assert pv.shape == (k, p * s * w)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ki))
    np.testing.assert_allclose(pv.numpy(), np.asarray(kv), rtol=2e-2)


@pytest.mark.parametrize("s,w", MODES)
def test_plain_modes_f32_match_xla_twin(s, w):
    """The f32 plain version with the index maps against JAX's
    ``_coarse_rank_xla`` fed the operands repeated per program, as the
    JAX package's CPU route feeds it: identical lags, values to 1e-4."""
    p, n, d, k, v = 2, 512, 64, 24, 1024
    ops, b, sup, nv = _modes_operands(p, s, w, n, d, k, v, planted=False)
    ws1, ws2, lmat, h_ext = ops
    lmat_rep = jnp.repeat(lmat, w, axis=0)
    ln = h_ext.shape[-1]
    h_rep = jnp.broadcast_to(h_ext.reshape(p, 1, w, 2, ln),
                             (p, s, w, 2, ln)).reshape(p * s * w, 2, ln)
    xv, xi = jbs._coarse_rank_xla(ws1, ws2, lmat_rep, h_rep, b, sup, v,
                                  num_valid=None if nv is None
                                  else jnp.asarray(nv))
    tops = stein_operands_from_numpy(*ops, device="cpu")
    pv, pi = tfs.coarse_rank_plain(*tops, b, sup, v, windows=w, share_h=s,
                                   num_valid=nv)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))
    np.testing.assert_allclose(pv.numpy(), np.asarray(xv), rtol=1e-4)


def test_program_maps_match_kernel_index_maps():
    """``program_maps`` is the Pallas kernel's BlockSpec index maps."""
    s, w = 3, 4
    i = torch.arange(2 * s * w)
    li, hi = tfs.program_maps(i, w, s)
    assert li.tolist() == [j // w for j in range(2 * s * w)]
    assert hi.tolist() == [(j // (s * w)) * w + j % w
                           for j in range(2 * s * w)]


def test_zero_lag_bound_reads_minus_one_at_lag_zero():
    """A program whose ``num_valid`` is 0 returns -1.0 at lag 0 in every
    bin, as JAX's kernel in interpret mode does; a bound of 100 keeps
    every lag below it."""
    p, s, w, n, d, k, v = 1, 1, 3, 256, 32, 9, 512
    ops, b, sup, _ = _modes_operands(p, s, w, n, d, k, v, planted=False)
    nv = np.array([512, 0, 100], np.int32)
    kv, ki = jps.fused_stein_rank(*ops, b, sup, v, interpret=True,
                                  windows=w, num_valid=jnp.asarray(nv))
    tops = stein_operands_from_numpy(*ops, device="cpu")
    pv, pi = tfs.fused_stein_rank(*tops, b, sup, v, windows=w, num_valid=nv)
    assert pv[:, 1].tolist() == [-1.0] * k and pi[:, 1].tolist() == [0] * k
    assert int(pi[:, 2].max()) < 100
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ki))
    np.testing.assert_allclose(pv.numpy(), np.asarray(kv), rtol=2e-2)


# ---------------------------------------------------------------------------
# The error bound the CUDA kernel is held to (its stage B sums on the
# tensor cores in their own order): stage_b_error_bound, rank_bound_check
# ---------------------------------------------------------------------------

_BOUND_SHAPES = [(128, 32, 2048),     # 2B = 8
                 (2048, 32, 2048),    # 2B = 128
                 (1024, 8, 2048)]     # 2B = 256


def _bound_operands(n, d, m, k=37, seed=5):
    """Port operands on the CPU rounded to bf16, and the plain version's
    G (the kernel's bit for bit)."""
    needles, hays = _pairs(np.random.default_rng(seed), 1, n)
    nt, ht = torch.from_numpy(needles), torch.from_numpy(hays)
    b = n // d
    lmat, sup = tbs._needle_operator(nt.real, nt.imag, d)
    h_ext = tbs._haystack_extension(ht.real, ht.imag, m,
                                    tfs.fused_span(b, sup, m))
    ws1, ws2 = tfs.stein_synthesis_weights(torch.linspace(-300, 300, k), FS,
                                           b, d)
    ops = tuple(map(tfs._bf16, (ws1, ws2, lmat, h_ext)))
    g = tfs._plain_g(ops[2], ops[3], b, sup, m, torch.arange(1), 1, 1, True)
    return ops, b, sup, g


def _kernel_order_ratio(ws1, ws2, g, v, e):
    rr, ri = tfs._stage_b_row_by_row(ws1, ws2, g)
    return tfs._ratio(((rr * rr + ri * ri).double() - v).abs(), e)


@pytest.mark.parametrize("n,d,m", _BOUND_SHAPES)
def test_kernel_order_surface_within_bound(n, d, m):
    """The plain f32 surface, stage B summed row by row, sits well within
    the bound of the f64 surface at 2B = 8, 128 and 256; the CPU route's
    answer passes ``rank_bound_check`` in both modes."""
    ops, b, sup, g = _bound_operands(n, d, m)
    assert g.shape[1] == 2 * b
    v, e = tfs.stage_b_error_bound(ops[0], ops[1], g)
    assert v.dtype == e.dtype == torch.float64
    assert bool((e >= 0).all()) and bool((e > 0).any())
    assert _kernel_order_ratio(ops[0], ops[1], g, v, e) < 0.1
    got = tfs.fused_stein_rank(*ops, b, sup, m)
    r = tfs.rank_bound_check(got, *ops, b, sup, m)
    assert r["ok"] and r["ratio"] < 0.1 and r["lags_off_f32"] == 0, r
    got = tfs.fused_stein_rank(*ops, b, sup, m, want_top2=True, sep=4)
    r = tfs.rank_bound_check(got, *ops, b, sup, m, sep=4)
    assert r["ok"] and r["n"] == 2 * got[0].numel(), r


@pytest.mark.parametrize("n,d,m", _BOUND_SHAPES)
def test_one_bf16_ulp_in_g_breaks_bound(n, d, m):
    """G summed in another order lands single entries one bf16 ulp
    apart; one such entry (the largest, moved away from zero) takes the
    surface past the bound."""
    ops, b, sup, g = _bound_operands(n, d, m)
    v, e = tfs.stage_b_error_bound(ops[0], ops[1], g)
    flat = g.clone().view(-1)
    i = int(flat.abs().argmax())
    bits = flat[i:i + 1].to(torch.bfloat16).view(torch.int16) + 1
    flat[i] = bits.view(torch.bfloat16).float()[0]
    assert abs(float(flat[i])) > abs(float(g.view(-1)[i]))
    assert _kernel_order_ratio(ops[0], ops[1], flat.view(g.shape), v, e) > 1


def test_rank_bound_check_flags_wrong_answers():
    """A lag moved off the bin's max, a value moved past its bound, and a
    slot-2 lag inside slot 1's window each fail the check."""
    ops, b, sup, g = _bound_operands(1024, 32, 1024)
    vals, lags = tfs.fused_stein_rank(*ops, b, sup, 1024)
    assert tfs.rank_bound_check((vals, lags), *ops, b, sup, 1024)["ok"]
    moved = lags.clone()
    moved[5, 0] = (moved[5, 0] + 37) % 1024
    assert not tfs.rank_bound_check((vals, moved), *ops, b, sup, 1024)["ok"]
    off = vals.clone()
    off[3, 0] *= 1 + 1e-3
    r = tfs.rank_bound_check((off, lags), *ops, b, sup, 1024)
    assert not r["ok"] and r["ratio"] > 1
    top2 = list(tfs.fused_stein_rank(*ops, b, sup, 1024, want_top2=True,
                                     sep=8))
    assert tfs.rank_bound_check(top2, *ops, b, sup, 1024, sep=8)["ok"]
    top2[3] = top2[1] + 1
    assert not tfs.rank_bound_check(top2, *ops, b, sup, 1024, sep=8)["ok"]


def test_tile_shape_mirrors_the_kernel():
    """The wrapper's shared-memory, row-split and bin-split arithmetic
    (csrc ``TileSmem``, ``row_plan``, ``kBinPass``): a config-1 shape
    splits its 400 bins so every SM gets a block, a config-2 shape takes
    every bin in one block; 2B past one block's shared memory shares
    G's rows over a cluster (c = 1 up to 864 rows at D <= 16, at least 2
    at 1024), and 2B past 16 blocks is refused up front."""
    assert tfs._tile_smem_bytes(128, 64) == 128 * 136 * 2 + 2 * (
        2 * 800 + 32 * 64) * 4
    assert tfs._tile_smem_bytes(64, 128) <= tfs._SMEM_PER_BLOCK
    assert tfs._tile_smem_bytes(1024, 8) > tfs._SMEM_PER_BLOCK
    assert tfs._bins_per_split(400, 64, 132) == 192
    assert tfs._bins_per_split(400, 64 * 64, 132) == 448
    assert tfs._bins_per_split(2754, 56 * 64, 132) == 2754 + 62
    # 2B = 1024 at D = 8: two blocks a tile, 256 segments (512 rows) each.
    assert tfs._bins_per_split(400, 64 * 2, 132) == 256
    for d in (8, 16):
        for b2 in (2, 128, 512, 864):
            plan = tfs.check_kernel_shape(b2, d)
            assert plan.cluster == 1 and plan.rows == -(-b2 // 16) * 16
            assert plan.smem == tfs._tile_smem_bytes(b2, d)
        plan = tfs.check_kernel_shape(1024, d)
        assert plan.cluster >= 2 and plan.smem <= tfs._SMEM_PER_BLOCK
        assert plan.cluster * plan.seg >= 512 and plan.rows == 2 * plan.seg
    assert tfs.check_kernel_shape(1024, 8) == (2, 512, 202_752, 256)
    assert tfs.check_kernel_shape(1536, 8).cluster == 3
    assert tfs.check_kernel_shape(1872, 8).cluster == 3
    assert tfs.check_kernel_shape(4608, 8).cluster == 8
    top = tfs.row_ceiling(8)
    assert tfs.check_kernel_shape(top, 8).cluster == tfs.CLUSTER_MAX
    with pytest.raises(tfs.VmemBudgetError, match=f"ceiling of {top} rows"):
        tfs.check_kernel_shape(top + 2, 8)
    with pytest.raises(tfs.EligibilityError, match="multiple of 4"):
        tfs.check_kernel_shape(1024, 6)


def _jax_vmem_ok(b2, d, lags, k, want_idxs):
    """Whether JAX's ``_vmem_demand`` grants one program of
    ``fused_stein_rank`` at these shapes, called with the arguments that
    ``fused_stein_rank`` passes it (P = 1, ``a_chunks`` 4)."""
    span = jps.fused_span(b2 // 2, d, lags, 4)
    try:
        jps._vmem_demand(b2, span, d, min(jps._SEED_ROWS, d),
                         -(-lags // jps.FUSED_TILE) * jps.FUSED_TILE,
                         -(-k // jps.ROW_PAD) * jps.ROW_PAD, 1, 4, want_idxs)
    except jps.VmemBudgetError:
        return False
    return True


@pytest.mark.parametrize("top2", [False, True])
@pytest.mark.parametrize("k", [8, 400, 2000])
@pytest.mark.parametrize("lags", [1024, 4096, 8192, 16384])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_kernel_plan_takes_every_shape_jax_grants(d, lags, k, top2):
    """Wherever JAX's VMEM model grants K1 (``want_idxs`` on and off
    without top-2; top-2 forces it on), the port's plan takes the shape:
    a cluster of at most 16 blocks, each within a block's shared memory.
    Checked at the largest 2B JAX grants, found by bisection (the model
    grows with 2B), and at every 2B on a 16-row lattice below it."""
    modes = (True,) if top2 else (False, True)
    for want_idxs in modes:
        lo, hi = 1, 8192                         # segments B
        assert _jax_vmem_ok(2 * lo, d, lags, k, want_idxs)
        assert not _jax_vmem_ok(2 * hi, d, lags, k, want_idxs)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _jax_vmem_ok(2 * mid, d, lags, k, want_idxs):
                lo = mid
            else:
                hi = mid
        for b2 in list(range(16, 2 * lo, 16)) + [2 * lo]:
            plan = tfs.check_kernel_shape(b2, d)
            assert 1 <= plan.cluster <= tfs.CLUSTER_MAX
            assert plan.smem <= tfs._SMEM_PER_BLOCK
            assert plan.cluster * plan.seg >= b2 // 2


def test_k1_study_edits_find_their_sites():
    """Every mutant and stage-split edit of ``utils/k1_study`` finds its
    site in ``csrc/fused_stein.cu`` exactly once, so the studies edit the
    kernel they name: eight mutants (M6-M8 of the pipelined launch) and
    each split's edits of both tile launches."""
    from caf_cookoff_tpu_torch.utils import k1_study

    src = (pathlib.Path(tfs.__file__).resolve().parents[1] / "csrc"
           / "fused_stein.cu").read_text()
    edits = list(k1_study.MUTANTS.values()) + [
        e for v in k1_study.SPLITS.values() if v is not None for e in v]
    assert len(edits) == 13
    for old, new in edits:
        assert src.count(old) == 1
        assert src.replace(old, new) != src
