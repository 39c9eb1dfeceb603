"""device_ops_per_search: kernels, memcpys and memsets on the card over
the searches of the traced window (those replayed from CUDA graphs
included)."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.inside()) / run.trace.searches
