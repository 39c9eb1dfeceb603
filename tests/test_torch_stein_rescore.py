"""The Stein engines' exact re-score (``ops/stein_rescore``) on the CPU:
the wrapper's routing, and its plain chain against the chain the three
engines ran inline before it (``_refine_topk``, ``_batched_refine``,
``_os_topk_refine``), copied below as they were: the same candidates,
values bit for bit, lags and bins equal."""

import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError
from caf_cookoff_tpu_torch.models import batched_stein as tbs
from caf_cookoff_tpu_torch.models import stein as tstein
from caf_cookoff_tpu_torch.ops import _graph
from caf_cookoff_tpu_torch.ops import stein_rescore as rs
from caf_cookoff_tpu_torch.ops.peak import CafPeak
from caf_cookoff_tpu_torch.ops.xcor import _surface_rows, mag2

from test_torch_fixtures import chirp, fixture_pairs  # noqa: F401

FS = 48_000.0
M = 8192


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# The chain as the engines ran it inline, before the wrapper.

def _old_candidates(rowmax, freqs, needle_len, num_valid=None):
    from caf_cookoff_tpu_torch.ops.peak import (doppler_cell_bins,
                                                topk_separated)
    k = min(8, int(rowmax.shape[-1]), num_valid or 8)
    cand = torch.sort(rowmax, dim=-1, descending=True,
                      stable=True).indices[..., :k].to(torch.int32)
    sep = doppler_cell_bins(freqs, needle_len, FS)
    return torch.cat([cand, topk_separated(rowmax, min(4, k), sep)], dim=-1)


def _old_refine_topk(needle, haystack, freqs, rowmax, num_valid=None):
    cand = _old_candidates(rowmax, freqs, needle.shape[-1], num_valid)
    exact = mag2(_surface_rows(needle, haystack, freqs[cand.long()], FS, M))
    rowmax = torch.amax(exact, dim=-1)
    top = rowmax == torch.amax(rowmax)
    winner = torch.amin(torch.where(top, cand, torch.iinfo(torch.int32).max))
    best = torch.argmax((top & (cand == winner)).to(torch.int8)).reshape(1)
    return CafPeak(value=rowmax[best][0], freq_idx=cand[best][0],
                   lag_idx=torch.argmax(exact[best][0]).to(torch.int32))


def _old_pick(rowmax, cand, lags):
    top = rowmax == torch.amax(rowmax, dim=-1, keepdim=True)
    winner = torch.amin(torch.where(top, cand, torch.iinfo(torch.int32).max),
                        dim=-1, keepdim=True)
    best = torch.argmax((top & (cand == winner)).to(torch.int8), dim=-1,
                        keepdim=True)
    take = lambda a: torch.gather(a, -1, best)[..., 0]  # noqa: E731
    return CafPeak(value=take(rowmax), freq_idx=take(cand).to(torch.int32),
                   lag_idx=take(lags).to(torch.int32))


def _old_batched_refine(ns, hs, freqs, vals_t, num_valid=None):
    cand = _old_candidates(vals_t, freqs, ns.shape[-1], num_valid)
    exact = mag2(_surface_rows(ns, hs, freqs[cand.long()], FS, M))
    return _old_pick(torch.amax(exact, dim=-1), cand,
                     torch.argmax(exact, dim=-1))


def _old_os_topk_refine(ns, hs, freqs, rowmax, rowlag, total_lags,
                        needle_len, num_valid_bins=None):
    cand = _old_candidates(rowmax, freqs, needle_len, num_valid_bins)
    best_bin = torch.argmax(rowmax, dim=-1, keepdim=True)
    best_lag = torch.gather(rowlag, 1, best_bin)[:, 0]
    n, hay_len = needle_len, hs.shape[-1]
    guard = min(64, n // 4, max((hay_len - n) // 2, 0))
    win = n + 2 * guard
    start = torch.clamp(best_lag.long() - guard, 0, max(hay_len - win, 0))
    slices = torch.gather(hs, 1, start[:, None]
                          + torch.arange(win)[None, :])
    exact = mag2(_surface_rows(ns, slices, freqs[cand.long()], FS, M))
    local = torch.arange(M)
    ok = (local <= 2 * guard)[None, :] & (start[:, None] + local < total_lags)
    exact = torch.where(ok[:, None, :], exact, -1.0)
    pk = _old_pick(torch.amax(exact, dim=-1), cand,
                   torch.argmax(exact, dim=-1))
    return CafPeak(pk.value, pk.freq_idx,
                   (start + pk.lag_idx).to(torch.int32))


def _same(got: CafPeak, want: CafPeak):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (got, want)


def _grid(truth_hz: float, bins: int = 64, step: float = 0.25):
    f0 = step * round(truth_hz / step) - step * (bins // 2)
    return torch.from_numpy((f0 + step * np.arange(bins)).astype(np.float32))


def _ranking(needle, haystack, freqs):
    """The CPU route's coarse ranking: the f32 segmented rows' maxima."""
    rr, ri = tstein._stein_rows(needle, haystack, freqs, FS, M, 64)
    return torch.amax(rr * rr + ri * ri, dim=-1)


def _pair(chirp, idx):
    needle, hay, truth = chirp(idx)
    return (torch.from_numpy(needle), torch.from_numpy(hay),
            _grid(truth.freq_hz))


ROUTES = [
    # device ("meta" stands for a card: not the CPU), dtype, M, route
    ("meta", torch.complex64, 8192, "kernel"),
    ("meta", torch.complex64, 32, "kernel"),
    ("meta", torch.complex64, 131072, "kernel"),
    ("meta", torch.complex128, 8192, EligibilityError),
    ("meta", torch.complex64, 262144, VmemBudgetError),
    ("meta", torch.complex64, 16, EligibilityError),
    ("meta", torch.complex64, 12288, EligibilityError),
    ("cpu", torch.complex64, 8192, "plain"),
    ("cpu", torch.complex128, 8192, "plain"),
    ("cpu", torch.complex64, 262144, "plain"),
]


@pytest.mark.parametrize("device,dtype,m,route", ROUTES)
def test_routes_by_device_dtype_and_m(monkeypatch, device, dtype, m, route):
    """CPU tensors take the plain chain, whatever their dtype and M; off
    the CPU only K5 runs: complex64 with a power-of-two 32 <= M <= 131072
    (K2's block transform) launches it, and anything else raises before a
    launch, with no plain chain on a card."""
    calls = []
    monkeypatch.setattr(rs, "rescore_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(rs, "rescore_kernel", lambda *a, **k: calls.append(
        "kernel") or SimpleNamespace(peak=None))
    n = torch.zeros((1, 16), dtype=dtype, device=device)
    ranking = torch.zeros((1, 9), device=device)
    args = (n, n, torch.zeros(9, device=device), ranking, FS, m, 16)
    if isinstance(route, str):
        rs.stein_rescore(*args)
        assert calls == [route]
    else:
        with pytest.raises(route, match="Stein re-score kernel"):
            rs.stein_rescore(*args)
        assert calls == []


def test_cpu_call_is_the_plain_chain_and_counts_no_launch(chirp):
    n, h, freqs = _pair(chirp, 0)
    ranking = _ranking(n, h, freqs)
    before = rs.RESCORE_LAUNCHES
    got = rs.stein_rescore(n, h, freqs, ranking, FS, M, n.shape[-1])
    assert rs.RESCORE_LAUNCHES == before
    _same(got, rs.rescore_plain(n, h, freqs, ranking, FS, M, n.shape[-1]))


def test_replays_count_the_rescore():
    """A replay adds each captured K5 call to ``RESCORE_LAUNCHES``."""
    assert (rs, "RESCORE_LAUNCHES") in _graph._COUNTERS


def test_rejects_signals_longer_than_m():
    n = torch.zeros(64, dtype=torch.complex64)
    with pytest.raises(ValueError, match="longer than M"):
        rs.stein_rescore(n, n, torch.zeros(4), torch.zeros(4), FS, 32, 64)


@pytest.mark.parametrize("idx", range(10))
def test_refine_topk_equals_the_inline_chain(chirp, idx):
    n, h, freqs = _pair(chirp, idx)
    ranking = _ranking(n, h, freqs)
    _same(tstein._refine_topk(n, h, freqs, ranking, FS, M),
          _old_refine_topk(n, h, freqs, ranking))


@pytest.mark.parametrize("num_valid", [None, 40, 5])
def test_batched_refine_equals_the_inline_chain(chirp, num_valid):
    """Three pairs, one grid; a banded ranking's -inf padding past
    ``num_valid`` included."""
    pairs = [_pair(chirp, i) for i in (0, 3, 9)]
    freqs = _grid(0.0, bins=400, step=0.5)
    ns = torch.stack([p[0] for p in pairs])
    hs = torch.stack([p[1] for p in pairs])
    vals = torch.stack([_ranking(p[0], p[1], freqs) for p in pairs])
    if num_valid is not None:
        vals = torch.where(torch.arange(400) < num_valid, vals, -np.inf)
    _same(tbs._batched_refine(ns, hs, freqs, vals, FS, M, num_valid),
          _old_batched_refine(ns, hs, freqs, vals, num_valid))


@pytest.mark.parametrize("total_lags", [None, 260, 1])
def test_os_topk_refine_equals_the_inline_chain(fixture_pairs, total_lags):
    """The golden capture re-scored on a guard-extended slice; a lag range
    that ends inside the slice (260) or at its first lag (1) bounds it."""
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle = torch.from_numpy(load_c64(fixture_pairs[0][0]))
    hay = torch.from_numpy(load_c64(fixture_pairs[0][1]))
    n = needle.shape[-1]
    total = total_lags or hay.shape[-1] - n + 1
    freqs = _grid(69.25, bins=96)
    # The coarse ranking over the first 256 lags, as a window would give.
    rr, ri = tstein._stein_rows(needle, hay[:n + 256], freqs, FS, M, 64)
    rowmax, rowlag = torch.max((rr * rr + ri * ri)[:, :256], dim=-1)
    rowlag = torch.clamp(rowlag, max=total - 1).to(torch.int32)
    ns = needle[None]
    got = tbs._os_topk_refine(ns, hay[None], freqs, rowmax[None],
                              rowlag[None], FS, M, total, n)
    want = _old_os_topk_refine(ns, hay[None], freqs, rowmax[None],
                               rowlag[None], total, n)
    _same(got, want)
    assert int(got.lag_idx[0]) < total


@pytest.mark.parametrize("scores,num_valid,sep_hz,want", [
    # Duplicates: equal values lowest bin first, both plain and separated.
    ([1, 3, 3, 2, 3, 0], None, 0.5, [1, 2, 4, 3, 0, 5, 1, 4, 0, 0]),
    # K < 12: five plain picks, four separated.
    ([0, 4, 1, 3, 2], None, 0.5, [1, 3, 4, 2, 0, 1, 3, 0, 0]),
    # -inf padding past num_valid.
    ([2, 5, 1, -np.inf, -np.inf], 3, 0.5, [1, 0, 2, 1, 0, 0]),
    # sep >= K: one separated pick, the surplus slots 0.
    ([0, 4, 1, 3, 2], None, 100.0, [1, 3, 4, 2, 0, 1, 0, 0, 0]),
])
def test_candidates_on_the_kernel_edge_cases(scores, num_valid, sep_hz,
                                             want):
    """The integers K5's candidates are held to on the card: plain picks
    descending with equal values lowest bin first, at most ``num_valid``;
    separated picks greedy with ``|i - j| <= sep`` suppressed and the
    surplus slots 0.  sep = ceil((fs / N) / step): N = 96000 / sep_hz at
    a 0.5 Hz step (sep 1 at 0.5 Hz, 200 at 100 Hz)."""
    ranking = torch.tensor(scores, dtype=torch.float32)
    freqs = 0.5 * torch.arange(len(scores), dtype=torch.float32)
    needle_len = int(round(FS / sep_hz))
    got = rs._refine_candidates(ranking, freqs, needle_len, FS, num_valid)
    assert got.tolist() == want
    assert torch.equal(got, _old_candidates(ranking, freqs, needle_len,
                                            num_valid))


def test_fb_study_mutants_find_their_sites():
    """Every mutant of ``utils/fb_study`` finds its site exactly once in
    the row transform K2/K3 and K5 share, so a mutant edits the kernels
    it names."""
    from caf_cookoff_tpu_torch.utils import fb_study

    root = pathlib.Path(rs.__file__).resolve().parents[2]
    src = (root / fb_study.ROWS).read_text()
    assert len(fb_study.MUTANTS) == 4
    for old, new in fb_study.MUTANTS.values():
        assert src.count(old) == 1
        assert src.replace(old, new) != src
