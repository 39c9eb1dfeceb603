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


def _cell(freqs: np.ndarray, answer, lo: int, hi: int):
    """The (bin, lag) an answer names, or None off the grid or lags, or
    for what is no (freq, lag, value)."""
    if not isinstance(answer, (tuple, list)) or len(answer) != 3:
        return None
    freq, lag, _ = answer
    ks = np.flatnonzero(freqs == np.float32(freq))
    if len(ks) != 1 or not lo <= int(lag) < hi:
        return None
    return int(ks[0]), int(lag)


def peak_gap(freqs: np.ndarray, answer, ref: Dict, lo: int, hi: int
             ) -> float:
    cell = _cell(freqs, answer, lo, hi)
    if cell is None or cell not in ref["probes"]:
        return math.inf
    value = float(answer[2])
    r_star = ref["best"][2]
    if not math.isfinite(value):
        return math.inf
    return max(abs(value - r_star), r_star - ref["probes"][cell]) / r_star


def location_gap(freqs: np.ndarray, answer, best, probes: Dict, lo: int,
                 hi: int) -> float:
    """How far below ``best`` (bin, lag, value), the reference's peak
    over lags ``[lo, hi)``, the reference lies at the answer's cell."""
    cell = _cell(freqs, answer, lo, hi)
    if cell is None or cell not in probes:
        return math.inf
    return (best[2] - probes[cell]) / best[2]


def _key(answer):
    """A hashable copy of an answer (numpy arrays as their bytes)."""
    if isinstance(answer, np.ndarray):
        return answer.dtype.str, answer.shape, answer.tobytes()
    if isinstance(answer, (tuple, list)):
        return tuple(_key(a) for a in answer)
    return answer


def _judged(cell, reference, lo, hi, pairs, chunks, refs):
    """One distinct answer's numbers, compared with the cell's limits:
    the worst pair's ``peak_gap`` and, with chunks, ``chunk_misses``;
    and its readings, compared with nothing: the worst chunk's
    ``chunk_gap``."""
    if len(pairs) != cell.pairs:
        numbers = {"peak_gap": math.inf}
    else:
        numbers = {"peak_gap": max(peak_gap(cell.freqs, a, r, lo, hi)
                                   for a, r in zip(pairs, refs))}
    if chunks is None:
        return numbers, {}
    spans = reference.chunk_spans(cell)
    misses = len(spans) * abs(cell.pairs - len(chunks))
    worst = 0.0
    for local, r in zip(chunks, refs):
        misses += abs(len(spans) - len(local))
        for a, (a_lo, a_hi), best in zip(local, spans, r["spans"]):
            gap = location_gap(cell.freqs, a, best, r["probes"], a_lo, a_hi)
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
            distinct[key] = (k, entry.pairs(ans),
                             entry.chunks(ans) if chunked else None)
    probes: Dict[int, List[set]] = {}
    for k, pairs, chunks in distinct.values():
        rows = probes.setdefault(k, [set() for _ in range(cell.pairs)])
        named = [[a] for a in pairs]
        for p, local in enumerate(chunks or []):
            if p < len(named):
                named[p] = named[p] + list(local)
        for row, said in zip(rows, named):
            for a in said:
                c = _cell(cell.freqs, a, lo, hi)
                if c is not None:
                    row.add(c)
    refs = {k: reference.run(cell, pool[k], rows)
            for k, rows in sorted(probes.items())}
    judged = {key: _judged(cell, reference, lo, hi, pairs, chunks, refs[k])
              for key, (k, pairs, chunks) in distinct.items()}
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
