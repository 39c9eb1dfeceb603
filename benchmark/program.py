"""The port's own spans and counters in a traced window.

The port opens ``caf.`` spans at its layer boundaries while a
``torch.profiler`` runs (``caf_cookoff_tpu_torch/utils/profiling.py``
lists them): plain host events on the profiler's clock, which
``trace.from_profiler`` leaves out of the device's operations.  Its
``ops/_graph`` counts the bytes its CUDA graphs' replays copy in and
out.  This module reads both:

* :func:`collect`: the ``caf.`` spans of a finished profile, in seconds
  from the same base as ``trace.from_profiler``'s;
* :func:`span_ms`: a span's host ms a search over the window;
* :func:`chunk_enqueue_ms`: each stream chunk's host ms from its start
  to the end of its graph's launch, averaged;
* :func:`program_idle_gaps`: the device's idle time in the window by the
  innermost ``caf.`` span the host was in ("outside the port" elsewhere
  in a search, "between searches" outside them).

Run by hand, it profiles one cell as ``run.py --trace 1`` does and
prints the breakdown as one JSON line:

    python3 -m benchmark.program --workload <cell> --seed <n> [--seconds 2]

It wraps ``window.run`` and ``trace.from_profiler`` for that one run, to
read the port's counters around the window and the spans from the same
profile; ``run.py`` itself reads neither yet.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import stats

PREFIX = "caf."
# The spans that hold a whole public call or stream step: the device's
# idle time inside them and in no child is the port's own code between
# its layers.
ROOTS = ("caf.call", "caf.stream.build", "caf.stream.chunk",
         "caf.stream.best")
OUTSIDE = "outside the port"
BETWEEN = "between searches"
COUNTERS = ("REPLAYS", "COPY_IN_BYTES", "COPY_OUT_BYTES")

Spans = Dict[str, List[Tuple[float, float]]]


def collect(prof) -> Spans:
    """The host's ``caf.`` spans of a finished ``torch.profiler.profile``
    (name -> sorted intervals), in seconds from its first event, as
    ``trace.from_profiler`` times the rest."""
    from torch.autograd import DeviceType

    from benchmark.trace import _times_ns

    raw = prof.profiler.kineto_results.events()
    base = min((_times_ns(e)[0] for e in raw), default=0)
    spans: Spans = defaultdict(list)
    for e in raw:
        if e.name().startswith(PREFIX) and e.device_type() == DeviceType.CPU:
            a, b = _times_ns(e)
            spans[e.name()].append(((a - base) / 1e9, (b - base) / 1e9))
    return {k: sorted(v) for k, v in spans.items()}


def _inside(ivs, window):
    lo, hi = window
    return [(a, b) for a, b in ivs if a >= lo and b <= hi]


def span_ms(program: Spans, window, searches: int, name: str
            ) -> Optional[float]:
    """Host ms a search inside the spans named ``name`` that lie in the
    window; None where there are none."""
    ivs = _inside(program.get(name, []), window)
    if not ivs or not searches:
        return None
    return 1e3 * sum(b - a for a, b in ivs) / searches


def span_counts(program: Spans, window) -> Dict[str, int]:
    """How many of each span lie in the window."""
    return {k: len(_inside(v, window)) for k, v in program.items()
            if _inside(v, window)}


def chunk_enqueue_ms(program: Spans, window) -> Optional[float]:
    """The mean, over the window's ``caf.stream.chunk`` spans, of the
    host ms from a chunk's start to the end of the last
    ``caf.graph.launch`` inside it; None where no chunk replayed."""
    ends = [b for _, b in _inside(program.get("caf.graph.launch", []),
                                  window)]
    out = []
    for a, b in _inside(program.get("caf.stream.chunk", []), window):
        i = bisect.bisect_right(ends, b) - 1
        if i >= 0 and ends[i] >= a:
            out.append(1e3 * (ends[i] - a))
    return sum(out) / len(out) if out else None


class _Innermost:
    """The shortest span that holds a time, among the ``caf.`` spans and
    the searches."""

    def __init__(self, program: Spans, searches):
        self.spans = dict(program)
        self.starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        self.searches = searches
        self.search_starts = [a for a, _ in searches]
        self.edges = sorted({t for v in list(self.spans.values())
                             + [searches] for iv in v for t in iv})

    def at(self, t: float) -> str:
        best: Optional[Tuple[float, str]] = None
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                length = ivs[i][1] - ivs[i][0]
                if best is None or length < best[0]:
                    best = (length, name)
        if best:
            return best[1]
        i = bisect.bisect_right(self.search_starts, t) - 1
        inside = i >= 0 and self.searches[i][0] <= t <= self.searches[i][1]
        return OUTSIDE if inside else BETWEEN

    def split(self, a: float, b: float):
        """``(a, b)`` cut at every span's edge inside it."""
        lo = bisect.bisect_right(self.edges, a)
        hi = bisect.bisect_left(self.edges, b)
        cuts = [a] + self.edges[lo:hi] + [b]
        return list(zip(cuts[:-1], cuts[1:]))


def program_idle_gaps(trace, program: Spans) -> List[List]:
    """The device's idle time in the trace's window by the innermost
    ``caf.`` span the host was in, each gap cut at the spans' edges:
    ``[name, seconds]``, most first, every name."""
    lo, hi = trace.window
    where = _Innermost(program, trace.spans.get("search", []))
    by_span: Dict[str, float] = defaultdict(float)
    for a, b in stats.gaps(trace.busy(), lo, hi):
        for x, y in where.split(a, b):
            by_span[where.at((x + y) / 2)] += y - x
    return [[n, s] for n, s in sorted(by_span.items(), key=lambda kv: -kv[1])]


def inner_idle_share(gaps: List[List]) -> Optional[float]:
    """The share of the idle time inside searches that falls in a
    ``caf.`` span other than the :data:`ROOTS`."""
    inside = {n: s for n, s in gaps if n != BETWEEN}
    total = sum(inside.values())
    if not total:
        return None
    return sum(s for n, s in inside.items()
               if n not in ROOTS and n != OUTSIDE) / total


def profile_cell(name: str, seed: int, seconds: float, *,
                 device: str = "cuda", config=None, workload=None) -> Dict:
    """One traced run of cell ``name`` through ``run.run_cell``, with the
    port's spans and counters read from the same window."""
    from benchmark import run, trace, window
    from caf_cookoff_tpu_torch.ops import _graph

    seen: Dict = {}
    run_window, from_profiler = window.run, trace.from_profiler

    def counted(*args, **kw):
        seen["before"] = {k: getattr(_graph, k) for k in COUNTERS}
        try:
            return run_window(*args, **kw)
        finally:
            seen["after"] = {k: getattr(_graph, k) for k in COUNTERS}

    def reading(prof):
        seen["program"] = collect(prof)
        seen["trace"] = from_profiler(prof)
        return seen["trace"]

    window.run, trace.from_profiler = counted, reading
    try:
        result, info = run.run_cell(name, seed, seconds, True, device=device,
                                    config=config, workload=workload)
    finally:
        window.run, trace.from_profiler = run_window, from_profiler
    tr, program = seen["trace"], seen["program"]
    searches = tr.searches
    gaps = program_idle_gaps(tr, program)
    moved = {k: seen["after"][k] - seen["before"][k] for k in COUNTERS}
    cuda = device != "cpu"      # the CPU keeps no graphs
    copies = _graph.copy_bytes() if cuda else []
    pools = _graph.entries() if cuda else []
    return {
        "cell": name, "seed": seed, "correct": result["correct"],
        "searches": searches, "window_s": tr.window_s,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "span_ms": {n: span_ms(program, tr.window, searches, n)
                    for n in sorted(program)},
        "spans_per_search": {n: c / searches for n, c in
                             span_counts(program, tr.window).items()},
        "chunk_enqueue_ms": chunk_enqueue_ms(program, tr.window),
        "program_idle_gaps": gaps,
        "inner_idle_share": inner_idle_share(gaps),
        "replays_in_window": moved["REPLAYS"],
        "graph_copy_bytes_a_search": (moved["COPY_IN_BYTES"]
                                      + moved["COPY_OUT_BYTES"]) / searches,
        "graph_copy_bytes": [[k[0].__qualname__, i, o] for k, i, o in copies],
        "graph_pool_bytes": sum(p for _, _, p in pools),
        "breakdown": result.get("breakdown"), "card": info["card"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m benchmark.program",
        description="Profile one cell as a --trace 1 run does and print "
                    "where the host's time and the device's idle time go, "
                    "by the port's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from benchmark import run

    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("benchmark.program: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps(profile_cell(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
