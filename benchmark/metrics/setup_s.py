"""setup_s: from the process's start to the window's first call: the
imports, the card's start, the kernel library's load (its nvcc build
on a checkout's first run), the inputs and the warm-up with its CUDA
graph captures (host clock)."""


def read(run):
    return run.setup_s
