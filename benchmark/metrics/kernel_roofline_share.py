"""kernel_roofline_share (%): a search's least device time over the
device time of every kernel in a search, in the traced window.  The
least time is ``roofline.search_bound``'s: the Stein rank of the cell's
grid at the bf16 tensor-core peak, or the search's inputs and answers
at the HBM rate, whichever is more, from the cell's sizes alone."""


def read(run):
    if run.trace is None or run.bound is None:
        return None
    kernel_s = sum(b - a for _, a, b in run.trace.kernels())
    if kernel_s <= 0:
        return None
    return 100.0 * run.bound["least_s"] * run.trace.searches / kernel_s
