"""chunk_ms_p95: the 95th percentile of every ``process()`` call's time
in the window (CUDA events, closed when the chunk's peak is on the
host): the latency a live feed feels.  Only entries with chunks mark
them."""

from benchmark import stats, window


def read(run):
    ms = window.step_ms(run.durations, "chunk")
    return stats.percentile(ms, 95) if ms else None
