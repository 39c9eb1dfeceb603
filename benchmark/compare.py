"""How ``correct`` is decided: every answer of the window against the
plain reference.

Once the window has closed, the reference (``reference/<entry>.py``)
runs once over each pool item that was searched, in complex128, and
reads its value at every cell the port answered with.  Each pair's
answer ``(freq, lag, value)`` is judged by its ``peak_gap``:

    max(|value - R*|, R* - R[freq, lag]) / R*

where R* is the reference's largest ``|CAF|^2`` over the grid and the
entry's lags, and R[freq, lag] the reference's value at the answer's
cell: how far the answer's value lies from the true peak, or its cell
below the true peak, whichever is more.  A cell a near-tie away reads
its tie's size; a wrong bin or lag reads the mainlobe's fall; an answer
off the grid or outside the entry's lags reads infinity, and so does a
search that answers another number of pairs than it was given.

On a cell with a rate grid (``Cell.rates``) an answer is ``(rate, freq,
lag, value)``, keyed (rate index, bin, lag); a rate off the grid reads
infinity like a frequency off it.

An entry that answers several emitters a pair (``slots``: each pair's
answers, strongest first, an empty slot's value -inf) is judged slot by
slot against its reference's greedy exclusion lattice (``slots`` and
``box`` in the reference's result): slot j by the same ``peak_gap``
against that slot's own peak R*_j.  A slot reads infinity where its
answer lies inside the box of an earlier answered slot, off the grid or
the lags, where it is empty and the reference's is not (or the other
way round), and so does a pair that answers another number of slots
than the reference has.  ``peak_gap`` is the worst over pairs and
slots.  An entry without ``slots`` answers one slot a pair, its
``pairs``, judged against the reference's 2-D argmax.

An entry that answers each chunk it is fed (``chunks``) has its chunk
peaks held to what the entry guarantees of them: one a chunk, on the
grid, at a lag that chunk ranks (``reference.chunk_spans``).
``chunk_misses`` counts the chunk peaks of a search that break this,
and its limit is 0.  Their cells are not judged against the chunk's
true peak: the stream's chunk peaks are a coarse rank's, by the entry's
contract, and read further from the chunk's true peak than the bfloat16
control's do, so no limit lies between the two.  Their distance
(``chunk_gap``, the location term of ``peak_gap`` against the chunk's
own peak) is kept among the run's readings, compared with nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _cell(cell, answer, lo: int, hi: int):
    """The key an answer names, (bin, lag) or on a rate cell (rate
    index, bin, lag), or None off the grids or the lags, or for what is
    no answer of the cell's shape."""
    grids = cell.grids
    if not isinstance(answer, (tuple, list)) or len(answer) != len(
            grids) + 2:
        return None
    key = []
    for grid, x in zip(grids, answer):
        ks = np.flatnonzero(grid == np.float32(x))
        if len(ks) != 1:
            return None
        key.append(int(ks[0]))
    lag = answer[-2]
    if not lo <= int(lag) < hi:
        return None
    return (*key, int(lag))


def _empty(answer) -> bool:
    """An empty slot: an answer whose value is -inf."""
    return (isinstance(answer, (tuple, list)) and len(answer) > 0
            and answer[-1] == -math.inf)


def peak_gap(cell, answer, best, probes: Dict, lo: int, hi: int) -> float:
    """``answer``'s gap against ``best`` (*key, value), the reference's
    peak, with ``probes`` the reference's values at the answered keys."""
    key = _cell(cell, answer, lo, hi)
    if key is None or key not in probes:
        return math.inf
    value = float(answer[-1])
    r_star = best[-1]
    if not math.isfinite(value):
        return math.inf
    return max(abs(value - r_star), r_star - probes[key]) / r_star


def slots_gap(cell, said: List, ref: Dict, lo: int, hi: int) -> float:
    """The worst slot's ``peak_gap`` of one pair's answers ``said``,
    strongest first, against the reference's lattice."""
    want = ref["slots"]
    if len(said) != len(want):
        return math.inf
    worst, earlier = 0.0, []
    for answer, best in zip(said, want):
        if _empty(answer) or best is None:
            if _empty(answer) and best is None:
                continue
            return math.inf
        key = _cell(cell, answer, lo, hi)
        if key is None or any(ref["box"].covers(at, key) for at in earlier):
            return math.inf
        earlier.append(key)
        worst = max(worst, peak_gap(cell, answer, best, ref["probes"], lo,
                                    hi))
    return worst


def location_gap(cell, answer, best, probes: Dict, lo: int,
                 hi: int) -> float:
    """How far below ``best`` (*key, value), the reference's peak over
    lags ``[lo, hi)``, the reference lies at the answer's cell."""
    key = _cell(cell, answer, lo, hi)
    if key is None or key not in probes:
        return math.inf
    return (best[-1] - probes[key]) / best[-1]


def _key(answer):
    """A hashable copy of an answer (numpy arrays as their bytes)."""
    if isinstance(answer, np.ndarray):
        return answer.dtype.str, answer.shape, answer.tobytes()
    if isinstance(answer, (tuple, list)):
        return tuple(_key(a) for a in answer)
    return answer


def _judged(cell, reference, lo, hi, slots, chunks, refs):
    """One distinct answer's numbers, compared with the cell's limits:
    the worst pair's and slot's ``peak_gap`` and, with chunks,
    ``chunk_misses``; and its readings, compared with nothing: the
    worst chunk's ``chunk_gap``."""
    if len(slots) != cell.pairs:
        numbers = {"peak_gap": math.inf}
    else:
        numbers = {"peak_gap": max(slots_gap(cell, s, r, lo, hi)
                                   for s, r in zip(slots, refs))}
    if chunks is None:
        return numbers, {}
    spans = reference.chunk_spans(cell)
    misses = len(spans) * abs(cell.pairs - len(chunks))
    worst = 0.0
    for local, r in zip(chunks, refs):
        misses += abs(len(spans) - len(local))
        for a, (a_lo, a_hi), best in zip(local, spans, r["spans"]):
            gap = location_gap(cell, a, best, r["probes"], a_lo, a_hi)
            if math.isinf(gap):
                misses += 1
            else:
                worst = max(worst, gap)
    numbers["chunk_misses"] = misses
    return numbers, {"chunk_gap": worst}


def judge(cell, entry, reference, pool: List[Dict], answers, limits: Dict
          ) -> Dict:
    """``answers`` [(pool index, answer)] of the window against
    ``reference``: ``{"numbers": {name: value}, "readings": {name:
    value}, "failed": searches that failed}``, each number and reading
    the worst of the window.  Each distinct answer of a pool item is
    judged once."""
    lo, hi, _ = reference.lag_range(cell)
    chunked = hasattr(entry, "chunks")
    keys = [(k, _key(ans)) for k, ans in answers]
    distinct: Dict = {}
    for key, (k, ans) in zip(keys, answers):
        if key not in distinct:
            slots = entry.slots(ans) if hasattr(entry, "slots") else [
                [a] for a in entry.pairs(ans)]
            distinct[key] = (k, [list(s) for s in slots],
                             entry.chunks(ans) if chunked else None)
    probes: Dict[int, List[set]] = {}
    for k, slots, chunks in distinct.values():
        rows = probes.setdefault(k, [set() for _ in range(cell.pairs)])
        named = list(slots)
        for p, local in enumerate(chunks or []):
            if p < len(named):
                named[p] = named[p] + list(local)
        for row, said in zip(rows, named):
            for a in said:
                c = _cell(cell, a, lo, hi)
                if c is not None:
                    row.add(c)
    refs = {k: reference.run(cell, pool[k], rows)
            for k, rows in sorted(probes.items())}
    judged = {key: _judged(cell, reference, lo, hi, slots, chunks, refs[k])
              for key, (k, slots, chunks) in distinct.items()}
    failed = sum(any(v > limits[name] for name, v in judged[key][0].items())
                 for key in keys)
    return {"numbers": _worst(n for n, _ in judged.values()),
            "readings": _worst(r for _, r in judged.values()),
            "failed": failed}


def _worst(dicts) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in dicts:
        for name, v in d.items():
            out[name] = max(out.get(name, v), v)
    return out
