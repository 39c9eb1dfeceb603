"""The plain reference: equal to the CAF summed term by term, finds
injected truths, and its bfloat16 control fails every cell's limit."""

import math

import numpy as np
import pytest

from benchmark import calibrate, spec
from benchmark import cell as cells
from benchmark.reference import caf

FS = 48000.0


def _direct(needle, hay, freqs, lags):
    """sum_t h[tau + t] conj(n[t] exp(2j pi f t / fs)), h zero outside
    its samples, in float64, term by term: (bins, lags) |.|^2."""
    t = np.arange(len(needle))
    out = np.zeros((len(freqs), len(lags)))
    for i, f in enumerate(freqs):
        s = needle * np.exp(2j * np.pi * float(f) * t / FS)
        for j, tau in enumerate(lags):
            idx = tau + t
            ok = (idx >= 0) & (idx < len(hay))
            out[i, j] = abs(np.sum(hay[idx[ok]] * np.conj(s[ok]))) ** 2
    return out


def _rand(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


@pytest.mark.parametrize("case", ["circular", "window", "stream"])
def test_equals_direct_sum(case):
    rng = np.random.default_rng(5)
    n = 16
    needle = _rand(rng, n)
    freqs = np.array([-900.0, -100.0, 0.0, 350.0, 2000.0], np.float32)
    spans = []
    if case == "circular":           # a pair of equal lengths, 2N lags
        hay, m, lo, hi = _rand(rng, n), 32, 0, 32
        lags = [tau if tau < n else tau - m for tau in range(m)]
    elif case == "window":           # a capture, needle wholly inside
        hay, m, lo, hi = _rand(rng, 40), 64, 0, 25
        lags = list(range(lo, hi))
    else:                            # a stream from its first sample,
        hay, m, lo, hi = _rand(rng, 40), 64, -(n - 1), 25  # in 3 chunks
        lags = list(range(lo, hi))
        spans = [(-15, -3), (-3, 9), (9, 25)]
    want = _direct(needle, hay, freqs, lags)
    k, j = np.unravel_index(np.argmax(want), want.shape)
    probes = [[(i, lo + jj) for i in range(len(freqs))
               for jj in range(hi - lo)]]
    got, = caf.peaks(needle[None], hay[None], freqs, FS, m, lo, hi, probes,
                     device="cpu", spans=spans)
    assert got["best"][:2] == (k, lo + j)
    assert len(got["spans"]) == len(spans)
    for (a, b), best in zip(spans, got["spans"]):
        part = want[:, a - lo:b - lo]
        kk, jj = np.unravel_index(np.argmax(part), part.shape)
        assert best[:2] == (kk, a + jj)
        assert math.isclose(best[2], part[kk, jj], rel_tol=1e-12)
    assert math.isclose(got["best"][2], want[k, j], rel_tol=1e-12)
    for (i, tau), v in got["probes"].items():
        assert math.isclose(v, want[i, tau - lo], rel_tol=1e-9,
                            abs_tol=1e-9 * want.max())


@pytest.mark.parametrize("lag", [37, -21])
def test_finds_injected_truth(lag):
    """A needle delayed (or advanced) and shifted onto bin 7: the 2-D
    argmax is there, a negative lag at its circular index."""
    rng = np.random.default_rng(9)
    n, m = 512, 1024
    needle = _rand(rng, n)
    freqs = (-100.0 + 5.0 * np.arange(40)).astype(np.float32)
    t = np.arange(n)
    shifted = needle * np.exp(2j * np.pi * float(freqs[7]) * t / FS)
    hay = 1e-3 * _rand(rng, n)
    if lag >= 0:
        hay[lag:] += shifted[:n - lag].astype(np.complex64)
    else:
        hay[:n + lag] += shifted[-lag:].astype(np.complex64)
    got, = caf.peaks(needle[None], hay[None], freqs, FS, m, 0, m, [[]],
                     device="cpu")
    assert got["best"][:2] == (7, lag % m)


@pytest.mark.parametrize("name", ["cookoff.single", "widearea.capture",
                                  "widearea.stream", "cookoff.batch64"])
def test_each_entry_finds_the_recipe_truth(name, small):
    config, workload = small(name)
    cell = cells.load(name, "cpu", config, workload)
    reference = spec.load_module("reference", cell.workload["entry"])
    item = cells.make_pool(cell, 2 ** 31 + 1)[0]
    refs = reference.run(cell, item, [[]] * cell.pairs)
    lo, hi, m = reference.lag_range(cell)
    for r, (freq, lag) in zip(refs, item["truths"]):
        k, tau, _ = r["best"]
        if name.startswith("widearea"):
            assert (float(cell.freqs[k]), tau) == (freq, lag)
        else:
            # The offset lies between bins; along the chirp's
            # delay-doppler ridge the nearest cell may sit a lag away.
            assert abs(tau - lag) <= 1
            assert abs(float(cell.freqs[k]) - freq) <= cell.config[
                "freq_step_hz"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 35])
@pytest.mark.parametrize("name", ["cookoff.single", "widearea.capture",
                                  "widearea.stream", "cookoff.batch64"])
def test_control_fails_the_limit(name, seed, small):
    """The reference one precision down (bfloat16 operands), put in the
    port's place and judged as a run judges the port, fails: its
    peak_gap lies past the cell's limit."""
    config, workload = small(name)
    limit = spec.load_json("workloads", name)["limits"]["peak_gap"]
    verdict = calibrate.control(name, seed, "cpu", config, workload)
    assert verdict["failed"] > 0
    assert verdict["numbers"]["peak_gap"] > 3 * limit


def test_chunk_spans_tile_the_stream_lags(small):
    """The stream's chunks rank every lag of the capture once, in order,
    each chunk as many lags as it has samples."""
    config, workload = small("widearea.stream")
    cell = cells.load("widearea.stream", "cpu", config, workload)
    reference = spec.load_module("reference", "streaming_stein")
    lo, hi, _ = reference.lag_range(cell)
    spans = reference.chunk_spans(cell)
    assert spans[0][0] == lo and spans[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    cap = config["lags"] + config["needle_len"]
    sizes = [b - a for a, b in spans]
    assert sizes[:-1] == [workload["chunk_len"]] * (len(spans) - 1)
    assert sum(sizes) == cap
