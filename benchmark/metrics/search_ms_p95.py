"""search_ms_p95: the 95th percentile of every search's time in the
window, each between CUDA events on the card's clock, closed when the
answer is on the host."""

from benchmark import stats, window


def read(run):
    ms = window.search_ms(run.durations)
    return stats.percentile(ms, 95) if ms else None
