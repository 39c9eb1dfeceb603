"""graph_copy_mb (MB): the bytes a search's CUDA-graph replays copy into
their graphs' input buffers and clone out of their outputs
(``ops/_graph``'s ``COPY_IN_BYTES`` and ``COPY_OUT_BYTES``), over 1e6.

The counters are read once, after the window.  Every search of a cell
replays the same keys, and set-up ran ``WARMUP_PASSES`` passes over the
pool, whose first search captured each key (a capture copies nothing).
So a search's bytes are the counters' sum, plus one replay of each
graph kept, over the searches of set-up and of the window.  None where
the port has no such counters, where a graph was dropped or captured
again, or where nothing was replayed (the CPU)."""

from benchmark import run as harness


def read(run):
    from caf_cookoff_tpu_torch.ops import _graph

    kept = getattr(_graph, "copy_bytes", None)
    if kept is None or run.cell.device == "cpu" or not _graph.REPLAYS:
        return None
    graphs = kept()
    if len(graphs) != _graph.CAPTURES:
        return None
    searches = (harness.WARMUP_PASSES * int(run.cell.workload["pool"])
                + run.searches)
    copied = (_graph.COPY_IN_BYTES + _graph.COPY_OUT_BYTES
              + sum(i + o for _, i, o in graphs))
    return copied / searches / 1e6
