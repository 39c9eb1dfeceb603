"""syncs_per_search: the host's waits on the card
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) over the searches of the traced window."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.syncs_inside() / run.trace.searches
