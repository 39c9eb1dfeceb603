"""Several emitters a pair and a doppler-rate axis: the reference's
greedy exclusion lattice equals a direct greedy sum and the port's
``find_peaks``, and the judge holds each slot and each rate as strictly
as a single peak.  The toy cells, entries and references live here, not
as files of the benchmark."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import calibrate, compare, spec
from benchmark import cell as cells
from benchmark.reference import caf
from benchmark.tests.test_benchmark_reference import _direct, _rand

FS = 48000.0
N = 256
EF, EL = 4, 2          # the toy lattice's box: fs / N in bins, lags
EMITTERS = ((1.0, 7, 20), (0.6, 24, 90))     # (amplitude, bin, lag)
RATE_STEP = 40000.0     # Hz/s: rates a 256-sample needle tells apart
LIMIT = 1e-5


def _greedy(surface, keys, slots, close):
    """The greedy exclusion lattice of ``surface`` (cells in the order
    ``keys`` gives them), term by term: each slot the first largest cell
    not ``close`` to an earlier slot, None when every cell is."""
    out = []
    for _ in range(slots):
        best = None
        for key, v in zip(keys, surface.reshape(-1)):
            if any(close(at[:-1], key) for at in out if at is not None):
                continue
            if best is None or v > best[-1]:
                best = (*key, float(v))
        out.append(best)
    return out


@pytest.mark.parametrize("case", ["circular", "window", "stream", "rates"])
def test_lattice_equals_direct_greedy_sum(case, monkeypatch):
    """Slot by slot, on tiny surfaces, in blocks of two bins.  The
    first slots only: the last cells outside the boxes overlap the
    needle by a sample or two, where every bin ties and rounding picks
    (the empty slots past them are ``test_lattice_equals_find_peaks``'s)."""
    monkeypatch.setattr(caf, "BLOCK_BYTES", 16 * 64 * 2)
    rng = np.random.default_rng(11)
    n = 16
    needle = _rand(rng, n)
    freqs = np.array([-900.0, -100.0, 0.0, 350.0, 2000.0], np.float32)
    chirps = None
    if case in ("circular", "rates"):
        hay, m, lo, hi, period = _rand(rng, n), 32, 0, 32, 32
        lags = [tau if tau < n else tau - m for tau in range(m)]
    elif case == "window":
        hay, m, lo, hi, period = _rand(rng, 40), 64, 0, 25, None
        lags = list(range(lo, hi))
    else:
        hay, m, lo, hi, period = _rand(rng, 40), 64, -(n - 1), 25, None
        lags = list(range(lo, hi))
    if case == "rates":
        t = np.arange(n) / FS
        chirps = np.exp(1j * np.pi * np.array([-4e7, 0.0, 3e7])[:, None]
                        * t[None, :] ** 2)
    box = caf.Box(2, 7, period)
    mods = [np.ones(n)] if chirps is None else list(chirps)
    surface = np.stack([_direct(needle * c, hay, freqs, lags) for c in mods])
    pre = [()] if chirps is None else [(r,) for r in range(len(mods))]
    keys = [(*p, k, lo + j) for p in pre for k in range(len(freqs))
            for j in range(hi - lo)]
    slots = 5
    want = _greedy(surface, keys, slots, box.covers)
    values = sorted(w[-1] for w in want)
    assert all(b > a * (1 + 1e-6) for a, b in zip(values, values[1:]))
    got, = caf.peaks(needle[None], hay[None], freqs, FS, m, lo, hi, [[]],
                     device="cpu", slots=slots, box=box, chirps=chirps)
    assert got["slots"][0] == got["best"]
    assert [s if s is None else s[:-1] for s in got["slots"]] == [
        s if s is None else s[:-1] for s in want]
    for s, w in zip(got["slots"], want):
        if s is not None:
            assert math.isclose(s[-1], w[-1], rel_tol=1e-9)


def _fake_rows(surface, freqs):
    """A stand-in for the reference's rows: ``surface``'s rows of the
    bins asked for, by frequency."""
    def rows(n, h_spec, f, fs, m, precision):
        idx = [int(np.flatnonzero(freqs == np.float32(x))[0])
               for x in f.tolist()]
        return torch.from_numpy(surface[idx])
    return rows


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("period", [64, None], ids=["circular", "plain"])
def test_lattice_equals_find_peaks(case, period, monkeypatch):
    """On the same exact surface, the reference's lattice is the port's
    ``ops/peak.find_peaks``: cells, values and empty slots (value -inf
    there), exact ties taken in the same order."""
    from caf_cookoff_tpu_torch.ops.peak import find_peaks

    monkeypatch.setattr(caf, "BLOCK_BYTES", 16 * 64 * 2)
    rng = np.random.default_rng(3)
    freqs = (-100.0 + 5.0 * np.arange(9)).astype(np.float32)
    m = 64
    if case == "random":
        surface = rng.random((len(freqs), m)) ** 4
    else:
        surface = rng.integers(0, 3, (len(freqs), m)).astype(np.float64)
    monkeypatch.setattr(caf, "_rows", _fake_rows(surface, freqs))
    slots = 40
    got, = caf.peaks(np.zeros((1, 8), np.complex64),
                     np.zeros((1, 8), np.complex64), freqs, FS, m, 0, m,
                     [[]], device="cpu", slots=slots,
                     box=caf.Box(2, 5, period))
    pk = find_peaks(torch.from_numpy(surface), slots, 2, 5, period)
    empty = 0
    for s, v, k, lag in zip(got["slots"], pk.value.tolist(),
                            pk.freq_idx.tolist(), pk.lag_idx.tolist()):
        if s is None:
            assert v == -math.inf
            empty += 1
        else:
            assert s == (k, lag, v)
    assert 0 < empty < slots


def _toy_cell(rates=False, pairs=2, slots=2):
    config = {"sample_rate_hz": FS, "needle_len": N,
              "freq_start_hz": -1000.0, "freq_step_hz": 50.0, "bins": 40}
    if rates:
        config.update(rate_start_hz_per_s=-2 * RATE_STEP,
                      rate_step_hz_per_s=RATE_STEP, rates=5)
    workload = {"pairs_per_call": pairs, "num_peaks": slots,
                "limits": {"peak_gap": LIMIT}}
    return cells.Cell("toy", config, workload, "cpu")


def _chirps(cell):
    t = np.arange(N) / FS
    return np.exp(1j * np.pi * cell.rates.astype(np.float64)[:, None]
                  * t[None, :] ** 2)


def _toy_reference(box=caf.Box(EF, EL, 2 * N)):
    """Equal-length pairs, the full circular correlation (2N lags), the
    lattice under ``box`` (EF bins and EL lags, circular at 2N); on a
    rate cell every rate of its grid, window-start frequencies."""
    def lag_range(cell):
        return 0, 2 * N, 2 * N

    def run(cell, item, probes, precision="float64"):
        chirps = None if cell.rates is None else _chirps(cell)
        return caf.peaks(item["needles"], item["hays"], cell.freqs, cell.fs,
                         2 * N, 0, 2 * N, probes, precision, cell.device,
                         slots=int(cell.workload["num_peaks"]),
                         box=box, chirps=chirps)
    return SimpleNamespace(lag_range=lag_range, run=run)


def _toy_pool(cell, seed=2 ** 31 + 5, rate_index=3):
    """One item: per pair a noise needle and a haystack of two emitters
    (EMITTERS, each lag one later a pair) in weak noise; on a rate cell
    the emitters sweep at the grid's rate ``rate_index``."""
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    rate = 0.0 if cell.rates is None else float(cell.rates[rate_index])
    needles = np.empty((cell.pairs, N), np.complex64)
    hays = np.empty((cell.pairs, N), np.complex64)
    for p in range(cell.pairs):
        needles[p] = _rand(rng, N)
        hays[p] = 0.05 * _rand(rng, N)
        for amp, k, lag in EMITTERS:
            phase = float(cell.freqs[k]) * t / FS + rate / 2 * (t / FS) ** 2
            s = amp * needles[p] * np.exp(2j * np.pi * phase)
            hays[p, lag + p:] += s[:N - lag - p].astype(np.complex64)
    return [{"needles": needles, "hays": hays}]


def _surface(cell, item, p, r=None):
    """Pair ``p``'s exact (bins, 2N) |CAF|^2 (at rate index ``r``)."""
    n = torch.from_numpy(item["needles"][p]).to(torch.complex128)
    if r is not None:
        n = n * torch.from_numpy(_chirps(cell)[r])
    h = torch.fft.fft(torch.from_numpy(item["hays"][p]).to(
        torch.complex128), n=2 * N)
    return caf._rows(n, h, torch.from_numpy(cell.freqs.astype(np.float64)),
                     cell.fs, 2 * N, "float64").numpy()


def _answer(cell, key, value):
    """An answer at ``key`` (bin, lag) or (rate index, bin, lag), its
    value as a complex64 engine reports it."""
    *axes, lag = key
    return (*(float(g[i]) for g, i in zip(cell.grids, axes)), lag,
            float(np.float32(value)))


def _sound(cell, reference, pool):
    """Each pair's lattice as the exact reference has it, an empty slot
    as the engines give it: the grid's first cell, value -inf."""
    refs = reference.run(cell, pool[0], [()] * cell.pairs)
    empty = (0,) * len(cell.grids) + (0, -math.inf)
    return [[_answer(cell, s[:-1], s[-1])
             for s in (x or empty for x in r["slots"])] for r in refs]


SLOTS_ENTRY = SimpleNamespace(pairs=lambda a: [s[0] for s in a],
                              slots=lambda a: a)


def _judge(cell, reference, pool, answer, entry=SLOTS_ENTRY):
    return compare.judge(cell, entry, reference, pool, [(0, answer)],
                         cell.workload["limits"])


def test_sound_lattice_is_correct():
    cell, reference = _toy_cell(), _toy_reference()
    pool = _toy_pool(cell)
    answer = _sound(cell, reference, pool)
    assert [[a[:2] for a in s] for s in answer] == [
        [(float(cell.freqs[k]), lag + p) for _, k, lag in EMITTERS]
        for p in range(cell.pairs)]
    verdict = _judge(cell, reference, pool, answer)
    assert verdict["failed"] == 0
    assert 0 <= verdict["numbers"]["peak_gap"] < LIMIT / 10


def _sidelobe(cell, item, answer):
    """The second slot on the first one's sidelobe: its bin, just
    outside its box, with the reference's value there."""
    freq, lag, _ = answer[0]
    k = int(np.flatnonzero(cell.freqs == np.float32(freq))[0])
    side = lag + EL + 1
    answer[1] = _answer(cell, (k, side), _surface(cell, item, 1)[k, side])


def _in_box(cell, item, answer):
    """The second slot inside the first one's box, with the
    reference's value there."""
    freq, lag, _ = answer[0]
    k = int(np.flatnonzero(cell.freqs == np.float32(freq))[0])
    answer[1] = _answer(cell, (k, lag + 1), _surface(cell, item, 1)[k,
                                                                   lag + 1])


def _swapped(cell, item, answer):
    answer.reverse()


def _emptied(cell, item, answer):
    answer[1] = (float(cell.freqs[0]), 0, -math.inf)


def _one_too_many(cell, item, answer):
    """A third slot, outside both boxes."""
    answer.append(_answer(cell, (35, 300), _surface(cell, item, 1)[35, 300]))


def _one_too_few(cell, item, answer):
    answer.pop()


FAULTS = {"sidelobe": (_sidelobe, False), "in_box": (_in_box, True),
          "swapped": (_swapped, False), "empty": (_emptied, True),
          "one_too_many": (_one_too_many, True),
          "one_too_few": (_one_too_few, True)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_altered_lattice_is_not_correct(fault):
    """The second pair's slots altered where they are produced: each
    reads not correct; an answer in an earlier box, an empty slot and a
    count of slots other than the reference's read infinity."""
    cell, reference = _toy_cell(), _toy_reference()
    pool = _toy_pool(cell)
    answer = _sound(cell, reference, pool)
    alter, infinite = FAULTS[fault]
    alter(cell, pool[0], answer[1])
    verdict = _judge(cell, reference, pool, answer)
    gap = verdict["numbers"]["peak_gap"]
    assert verdict["failed"] == 1 and gap > 100 * LIMIT
    assert math.isinf(gap) == infinite


def test_empty_slot_where_the_reference_has_none_is_correct():
    """Past the last cell outside every box the reference's slots are
    empty: an answer empty there is sound, one that is not reads
    infinity.  A box over every lag: each slot takes 5 bins or more of
    the 40."""
    cell = _toy_cell(slots=12)
    reference = _toy_reference(caf.Box(EF, N, 2 * N))
    pool = _toy_pool(cell)
    answer = _sound(cell, reference, pool)
    assert answer[0][-1][-1] == -math.inf
    assert _judge(cell, reference, pool, answer)["failed"] == 0
    answer[0][-1] = answer[0][0][:2] + (1.0,)
    assert math.isinf(_judge(cell, reference, pool,
                             answer)["numbers"]["peak_gap"])


def test_entry_without_slots_is_judged_on_its_pairs():
    """An entry that answers one peak a pair is held to the reference's
    2-D argmax alone, as before slots existed."""
    cell, reference = _toy_cell(slots=1), _toy_reference()
    pool = _toy_pool(cell)
    sound = [s[0] for s in _sound(cell, reference, pool)]
    entry = SimpleNamespace(pairs=lambda a: a)
    assert _judge(cell, reference, pool, sound, entry)["failed"] == 0
    wrong = [sound[0], sound[1][:1] + (sound[1][1] + 1, sound[1][2])]
    assert _judge(cell, reference, pool, wrong, entry)["failed"] == 1


def _rate_answer(cell, reference, pool):
    return [[_answer(cell, s[:-1], s[-1])]
            for s in (r["best"] for r in reference.run(cell, pool[0],
                                                       [()] * cell.pairs))]


def test_sound_rate_answer_is_correct():
    cell = _toy_cell(rates=True, slots=1)
    reference = _toy_reference()
    pool = _toy_pool(cell, rate_index=3)
    answer = _rate_answer(cell, reference, pool)
    assert [a[0][:3] for a in answer] == [
        (float(cell.rates[3]), float(cell.freqs[7]), 20 + p)
        for p in range(cell.pairs)]
    verdict = _judge(cell, reference, pool, answer)
    assert verdict["failed"] == 0
    assert verdict["numbers"]["peak_gap"] < LIMIT / 10


@pytest.mark.parametrize("rate", ["off_grid", "past_grid"])
def test_rate_off_the_grid_reads_infinity(rate):
    cell = _toy_cell(rates=True, slots=1)
    reference = _toy_reference()
    pool = _toy_pool(cell, rate_index=3)
    answer = _rate_answer(cell, reference, pool)
    wrong = (float(cell.rates[3]) + RATE_STEP / 2 if rate == "off_grid"
             else float(cell.rates[-1]) + RATE_STEP)
    answer[1][0] = (wrong,) + answer[1][0][1:]
    verdict = _judge(cell, reference, pool, answer)
    assert verdict["failed"] == 1
    assert math.isinf(verdict["numbers"]["peak_gap"])


def test_wrong_rate_index_is_not_correct():
    """A rate one step off, on the grid, with the reference's value at
    that (rate, bin, lag): the mismatched chirp's fall."""
    cell = _toy_cell(rates=True, slots=1)
    reference = _toy_reference()
    pool = _toy_pool(cell, rate_index=3)
    answer = _rate_answer(cell, reference, pool)
    _, freq, lag, _ = answer[1][0]
    k = int(np.flatnonzero(cell.freqs == np.float32(freq))[0])
    value = _surface(cell, pool[0], 1, r=2)[k, lag]
    answer[1][0] = _answer(cell, (2, k, lag), value)
    verdict = _judge(cell, reference, pool, answer)
    assert verdict["failed"] == 1
    assert 100 * LIMIT < verdict["numbers"]["peak_gap"] < math.inf


def test_answer_without_its_rate_reads_infinity():
    cell = _toy_cell(rates=True, slots=1)
    reference = _toy_reference()
    pool = _toy_pool(cell, rate_index=3)
    answer = _rate_answer(cell, reference, pool)
    answer[0][0] = answer[0][0][1:]
    assert math.isinf(_judge(cell, reference, pool,
                             answer)["numbers"]["peak_gap"])


def test_rate_lattice_keys_carry_the_rate():
    """A lattice on a rate cell: two emitters sweeping at one rate, each
    slot keyed (rate index, bin, lag), and the box holds across rates:
    one over every bin, so that slot 2 is the second emitter, not the
    first one's ridge at another rate."""
    cell = _toy_cell(rates=True, slots=2)
    reference = _toy_reference(caf.Box(len(cell.freqs), EL, 2 * N))
    pool = _toy_pool(cell, rate_index=1)
    answer = _sound(cell, reference, pool)
    assert [[a[:3] for a in s] for s in answer] == [
        [(float(cell.rates[1]), float(cell.freqs[k]), lag + p)
         for _, k, lag in EMITTERS] for p in range(cell.pairs)]
    assert _judge(cell, reference, pool, answer)["failed"] == 0
    answer[0].reverse()
    assert _judge(cell, reference, pool, answer)["failed"] == 1


@pytest.mark.parametrize("rates", [False, True], ids=["lattice", "rates"])
def test_control_of_a_two_emitter_cell_fails_its_limit(rates, monkeypatch):
    """The bfloat16 control answers the cell's lattice (and its rate
    keys), and a limit set between the sound reading and the control's
    fails the control and passes the sound answer."""
    cell = _toy_cell(rates=rates)
    reference = _toy_reference()
    pool = _toy_pool(cell, rate_index=1)
    monkeypatch.setattr(cells, "load", lambda *a, **k: cell)
    monkeypatch.setattr(cells, "make_pool", lambda c, seed: pool)
    loaded = {"entries": SimpleNamespace(pairs=None, slots=None),
              "reference": reference}
    monkeypatch.setattr(spec, "load_module", lambda kind, name: loaded[kind])
    cell.workload["entry"] = "toy"
    ctrl = calibrate.control("toy", 1, "cpu")
    sound = _judge(cell, reference, pool, _sound(cell, reference, pool))
    lower, upper = sound["numbers"]["peak_gap"], ctrl["numbers"]["peak_gap"]
    assert upper > 30 * max(lower, 1e-9)
    limit = math.sqrt(max(lower, 1e-9) * upper)
    cell.workload["limits"] = {"peak_gap": limit}
    assert calibrate.control("toy", 1, "cpu")["failed"] == 1
    assert _judge(cell, reference, pool, _sound(cell, reference,
                                                pool))["failed"] == 0
