"""Multi-process start-up: one process per device over
``torch.distributed``.

The JAX package starts one controller per host
(``jax.distributed.initialize``) and builds one global mesh over every
host's chips.  Here every device is a process: ``torchrun
--nproc-per-node=N`` (or any launcher that sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) starts them, each calls
:func:`initialize_cluster`, builds the same mesh and calls the sharded
engines with the same host inputs:

    from caf_cookoff_tpu_torch.parallel import multihost
    from caf_cookoff_tpu_torch.parallel import sharded_overlap_save_peak
    multihost.initialize_cluster()                 # on every process
    mesh = multihost.global_mesh(pair=2, time=2)   # doppler: the rest
    peak = sharded_overlap_save_peak(needle, capture, freqs, fs, mesh)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from caf_cookoff_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       backend: str = "nccl",
                       timeout: Optional[datetime.timedelta] = None) -> None:
    """``torch.distributed.init_process_group`` over ``tcp://``.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``torchrun``'s environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``backend``
    is the default group's: ``nccl`` (cards) unless the caller asks for
    ``gloo`` (the CPU, or several processes sharing one card).  Call once
    per process, before building a mesh; a group that fails to form
    raises, and so does a collective that waits past ``timeout``
    (torch's default when not given)."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "no coordinator_address and no MASTER_ADDR/MASTER_PORT in "
                "the environment (start the processes with torchrun, or "
                "pass host:port)")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA card; torch sees none")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


def global_mesh(pair: int = 1, doppler: Optional[int] = None,
                time: int = 1, *, device=None,
                collectives: Optional[str] = None) -> Mesh:
    """Mesh over every process; ``doppler`` defaults to the rest."""
    n = dist.get_world_size()
    if doppler is None:
        if n % (pair * time):
            raise ValueError(
                f"{n} devices not divisible by pair*time = {pair * time}")
        doppler = n // (pair * time)
    return make_mesh(pair=pair, doppler=doppler, time=time, device=device,
                     collectives=collectives)


def process_info() -> str:
    """One-line summary of this process for logs."""
    return (f"process {dist.get_rank()}/{dist.get_world_size()}, "
            f"backend {dist.get_backend()}")


_Spec = Sequence[Union[None, str, Sequence[str]]]


def put_global(x, mesh: Mesh, spec: _Spec = ()) -> torch.Tensor:
    """This rank's shard of the host array ``x`` on its device.

    Every process passes the same full array; ``spec`` names, per
    leading dimension, the mesh axis (or axes, row-major) it is split
    over, ``None`` or a missing entry replicating it — the JAX
    ``PartitionSpec``: ``()`` replicates, ``("doppler",)`` splits the
    leading axis, ``("pair", "time")`` splits two."""
    x = np.asarray(x)
    index = []
    for dim, axes in enumerate(spec):
        if axes is None:
            index.append(slice(None))
            continue
        parts = mesh.axis_size(axes)
        if x.shape[dim] % parts:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) not "
                             f"divisible by {axes} ({parts})")
        size = x.shape[dim] // parts
        i = mesh.flat_index(axes)
        index.append(slice(i * size, (i + 1) * size))
    shard = np.ascontiguousarray(x[tuple(index)])
    return torch.from_numpy(shard).to(mesh.device)


def multihost_caf_peak(needle, haystack, freqs_hz, sample_rate, mesh: Mesh,
                       *, backend: str = "matmul"):
    """(freq_hz, lag, value) with the doppler bins sharded across
    PROCESSES: every process calls this with the same host inputs and
    reads the same replicated answer (the doppler-sharded
    :func:`~caf_cookoff_tpu_torch.parallel.sharded.sharded_caf_peak`)."""
    from caf_cookoff_tpu_torch.parallel.sharded import sharded_caf_peak

    return sharded_caf_peak(needle, haystack, freqs_hz, sample_rate, mesh,
                            backend=backend)


def free_port() -> int:
    """A TCP port on ``localhost`` that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: Sequence[str], nprocs: int, *, env=None,
                 port: Optional[int] = None):
    """Start ``nprocs`` copies of the command ``argv`` as the ranks of
    one world on this host, with ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), so each can call :func:`initialize_cluster` with no
    arguments.  Each rank's output goes to a temporary file; pass the
    returned processes to :func:`wait_local`."""
    import subprocess
    import tempfile

    port = port or free_port()
    procs = []
    for rank in range(nprocs):
        out = tempfile.TemporaryFile()
        rank_env = dict(os.environ if env is None else env,
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        WORLD_SIZE=str(nprocs), RANK=str(rank),
                        LOCAL_RANK=str(rank))
        procs.append((subprocess.Popen(list(argv), stdout=out,
                                       stderr=subprocess.STDOUT,
                                       env=rank_env), out))
    return procs


def wait_local(procs, timeout: float):
    """Wait for the ranks of :func:`launch_local`: ``[(returncode,
    output)]`` in rank order.  When a rank fails, or ``timeout`` seconds
    pass, every rank still running is killed (a rank left waiting in a
    collective would never end); a timeout raises ``TimeoutError``."""
    import time

    deadline = time.monotonic() + timeout
    timed_out = False
    while any(p.poll() is None for p, _ in procs):
        failed = any(p.poll() not in (None, 0) for p, _ in procs)
        timed_out = time.monotonic() > deadline
        if failed or timed_out:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            for p, _ in procs:
                p.wait()
            break
        time.sleep(0.05)
    results = []
    for p, out in procs:
        out.seek(0)
        results.append((p.returncode, out.read().decode(errors="replace")))
        out.close()
    if timed_out:
        raise TimeoutError(f"ranks still running after {timeout} s; killed:"
                           f" {[rc for rc, _ in results]}")
    return results
