"""K1's choice between its two tile launches (``ops/fused_stein``), on
the CPU: the pipelined launch (stage A's producer teams beside a
``wgmma`` warpgroup) or the tile launch, at the shapes each caller
gives it, and the pipelined block's shared memory and geometry.  The
shapes come from the callers' own planners, so a planner that moves a
caller onto the other launch shows here."""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu_torch import StreamingCAF
from caf_cookoff_tpu_torch.models import rate as rt
from caf_cookoff_tpu_torch.models._stein_plan import (_plan_bands,
                                                      _pow2_block_len)
from caf_cookoff_tpu_torch.ops import fused_stein as fs

FS = 48_000.0
NEEDLE = 4096
COOKOFF = np.arange(-100.0, 100.0, 0.5).astype(np.float32)    # 400 bins
WIDEAREA = np.arange(-500.0, 500.0, 0.5).astype(np.float32)   # 2000 bins
SMS = 132                                                     # an H100


def _cookoff_shape():
    d = _pow2_block_len(FS, COOKOFF, 64)
    return 2 * NEEDLE // d, d


def _capture_shape():
    d = _plan_bands(FS, WIDEAREA)["block_len"]
    return 2 * NEEDLE // d, d


def _stream_shape():
    needle = np.random.default_rng(0).standard_normal(NEEDLE).astype(
        np.complex64)
    s = StreamingCAF(needle, WIDEAREA, FS, chunk_len=8192, device="cpu",
                     backend="stein")
    return 2 * s._num_blocks, s._group


def _rate3_shape():
    rates = np.linspace(-200.0, 200.0, 9)
    d = rt._rate_routing(FS, WIDEAREA, rates, NEEDLE, 64,
                         65_536 + NEEDLE - 1)[0]
    return 2 * NEEDLE // d, d


# caller -> (its (2B, D), top-2, the launch it takes)
ROWS = {
    "cookoff.batch64, mode (b)": (_cookoff_shape, False, True),
    "cookoff.single, mode (a) at P = 1": (_cookoff_shape, False, True),
    "widearea.capture, mode (c+d)": (_capture_shape, False, True),
    "rate3, mode (f) tall K": (_rate3_shape, False, True),
    "widearea.stream chunk, mode (a), 2B = 512": (_stream_shape, False,
                                                  False),
    "wide1000, G's rows over a cluster": (lambda: (1024, 8), False, False),
    "lattices, mode (e) top-2": (_cookoff_shape, True, False),
}


@pytest.mark.parametrize("caller", list(ROWS))
def test_each_caller_takes_its_launch(caller):
    """Every row of the callers' table: the batch, the single pair, the
    windowed banded capture and the rate engines take the pipelined
    launch; the stream's chunk (two 2B = 512 G tiles do not fit), the
    cluster split and the top-2 mode (its recompute repeats the tile
    pass with the tile launch's device functions) keep the tile launch.
    ``parallel/`` shards give K1 their engine's shapes."""
    shape, top2, want = ROWS[caller]
    b2, d = shape()
    plan = fs.check_kernel_shape(b2, d)
    assert fs.pipelined(b2, d, top2, plan.cluster) is want


def test_caller_shapes_are_the_cells():
    """The planners give the benchmark cells' shapes: 2B = 128 at D = 64
    (cookoff), 64 at D = 128 (the capture, 6 bands of 375 bins; rate3),
    512 at D = 16 (the stream), and wide1000 splits over 2 blocks."""
    assert _cookoff_shape() == (128, 64)
    assert _capture_shape() == (64, 128)
    assert _plan_bands(FS, WIDEAREA)["bands"] == 6
    assert _rate3_shape() == (64, 128)
    assert _stream_shape() == (512, 16)
    assert fs.check_kernel_shape(1024, 8).cluster == 2


@pytest.mark.parametrize("b2,d", [(128, 64), (64, 128), (192, 64), (2, 8),
                                  (512, 16), (208, 64), (256, 8)])
def test_two_g_tiles_and_the_weight_ring_fit_a_block(b2, d):
    """The pipelined block's shared memory (csrc ``PipeSmem``): the
    barriers, a ring of 3 weight m-tiles (64 rows x 2B padded to 16,
    bf16), the two teams' G tiles (128 lags, each 8-lag group of 2B rows
    16 bytes past its core matrices) and their stage-A buffers (8
    segments a chunk), held against the 232,448 bytes a Hopper block may
    use; the launch is taken exactly where they fit."""
    kp = -(-b2 // 16) * 16
    ring = 3 * 64 * kp * 2
    g_tiles = 2 * (128 // 8) * (kp * 16 + 16)
    stage_a = 2 * fs._stage_a_bytes(d)
    total = 128 + ring + g_tiles + stage_a
    assert fs._pipe_smem_bytes(b2, d) == total
    assert fs.pipelined(b2, d, False, 1) is (total <= 232_448)
    assert fs._SMEM_PER_BLOCK == 232_448
    # 2B = 128, D = 64 (cookoff): 48 KB of ring, 64.5 KB of G, 57 KB of
    # stage A; 2B = 64, D = 128 (widearea): 24 KB, 32.5 KB, 109 KB.
    if (b2, d) == (128, 64):
        assert (ring, g_tiles, stage_a, total) == (49_152, 66_048, 58_368,
                                                   173_696)
    if (b2, d) == (64, 128):
        assert (ring, g_tiles, stage_a, total) == (24_576, 33_280, 111_616,
                                                   169_600)


@pytest.mark.parametrize("k,tiles,want", [
    (400, 64 * 64, (448, 132)),      # cookoff.batch64: every SM, 1 split
    (375, 48 * 64, (384, 132)),      # widearea.capture's programs
    (400, 64, (192, 132)),           # cookoff.single: 3 splits, as before
    (37, 2 * 16, (64, 32)),          # a small call: a block an item
    (2754, 48 * 64, (2754 + 62, 132)),   # rate3's rows
])
def test_pipelined_geometry(k, tiles, want):
    """Bins a split and persistent blocks: the bins split only where the
    (program, lag tile)s leave SMs idle (the tile launch's rule), and
    every block holds an item."""
    per_split, blocks = fs._pipe_geometry(k, tiles, SMS)
    assert (per_split, blocks) == want
    assert per_split == fs._bins_per_split(k, tiles, SMS)
    assert per_split % fs.BIN_PASS == 0
    items = tiles * -(-k // per_split)
    assert blocks == min(SMS, items)


def test_pipelined_launches_counter_is_a_replay_counter():
    """The counter beside ``LAUNCHES`` and ``SPLIT_LAUNCHES`` starts at
    0 and a captured graph's replay adds to it (``ops/_graph``)."""
    from caf_cookoff_tpu_torch.ops import _graph

    assert isinstance(fs.PIPELINED_LAUNCHES, int)
    assert (fs, "PIPELINED_LAUNCHES") in _graph._COUNTERS


def test_cpu_route_counts_no_pipelined_launch():
    """On CPU tensors the wrapper runs the plain version: no launch of
    either kind."""
    rng = np.random.default_rng(1)
    b, d, k, m = 4, 32, 9, 256
    ws1, ws2 = fs.stein_synthesis_weights(
        torch.linspace(-50.0, 50.0, k), FS, b, d)
    lmat = torch.from_numpy(rng.standard_normal((1, 2 * b, 2 * d)).astype(
        np.float32))
    span = fs.fused_span(b, d, m)
    h_ext = torch.from_numpy(rng.standard_normal(
        (1, 2, span + fs.SUPER - 1)).astype(np.float32))
    before = (fs.LAUNCHES, fs.PIPELINED_LAUNCHES)
    vals, lags = fs.fused_stein_rank(ws1, ws2, lmat, h_ext, b, d, m)
    assert vals.shape == lags.shape == (k, 1)
    assert (fs.LAUNCHES, fs.PIPELINED_LAUNCHES) == before
