"""search_ms: the window's length over the searches it completed (host
clock).  A search is the whole public call, from inputs already in
place to the answer on the host; a stream's is one whole capture."""


def read(run):
    if not run.searches:
        return None
    return 1e3 * run.window_s / run.searches
