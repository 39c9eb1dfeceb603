"""Device meshes over ``torch.distributed`` for the CAF engines.

The JAX package lays its chips out as one named ``jax.sharding.Mesh``
driven by a single controller.  Here every mesh position is a process
(SPMD, one process per device, as ``torchrun`` starts them), and a
:class:`Mesh` names the same three axes over the ranks of the default
process group, row-major:

* ``pair``    — independent (needle, haystack) pairs (data parallel);
* ``doppler`` — the frequency-bin axis;
* ``time``    — lag/time chunks of a long capture (overlap-save).

A mesh carries the device its rank computes on (``cuda:{local_rank %
device_count}`` by default, or the CPU when asked) and the backend of its
collectives, which is always explicit: ``nccl`` for a card by default,
``gloo`` for the CPU or when the caller asks for it (several ranks that
share one card: NCCL refuses two ranks on one GPU).  A group that fails
to form raises; nothing falls back to another backend or device.

``torch.distributed.device_mesh.DeviceMesh`` is not used: the engines
reduce over several axes at once (one group for ``(doppler, time)``,
as the JAX package's two-collective lattice gathers do), and need the
compute device and the collectives backend apart from a device type.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AXIS_PAIR = "pair"
AXIS_DOPPLER = "doppler"
AXIS_TIME = "time"

ALL_AXES = (AXIS_PAIR, AXIS_DOPPLER, AXIS_TIME)

_Axes = Union[str, Sequence[str]]


def factor_devices(n: int, num_axes: int) -> Tuple[int, ...]:
    """Split ``n`` devices into ``num_axes`` balanced factors.

    Greedy largest-prime-first round-robin; for the common power-of-two
    device counts this yields near-square factorizations, e.g.
    8 -> (2, 2, 2), 16 -> (4, 2, 2).
    """
    if n < 1 or num_axes < 1:
        raise ValueError(f"need n >= 1, num_axes >= 1, got {n}, {num_axes}")
    factors = [1] * num_axes
    remaining = n
    primes = []
    d = 2
    while d * d <= remaining:
        while remaining % d == 0:
            primes.append(d)
            remaining //= d
        d += 1
    if remaining > 1:
        primes.append(remaining)
    for p in sorted(primes, reverse=True):
        factors[int(np.argmin(factors))] *= p
    return tuple(sorted(factors, reverse=True))


def _axis_tuple(axes: _Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in ALL_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {ALL_AXES}")
    return tuple(a for a in ALL_AXES if a in names)


class Mesh:
    """A ``(pair, doppler, time)`` layout of the default process group's
    ranks (row-major: ``rank = (p*doppler + d)*time + t``).

    ``shape`` maps each axis to its size, as the JAX mesh's does;
    ``coords`` is this rank's position; ``device`` the device it
    computes on; ``backend`` its collectives' backend.  Built by
    :func:`make_mesh`.  Groups over one axis or several are made on
    first use by :meth:`group` — a collective call of every rank, which
    SPMD code makes in the same order everywhere.
    """

    def __init__(self, pair: int, doppler: int, time: int,
                 device: torch.device, backend: str):
        self.shape: Dict[str, int] = {AXIS_PAIR: pair, AXIS_DOPPLER: doppler,
                                      AXIS_TIME: time}
        self.size = pair * doppler * time
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = {
            a: int(i) for a, i in zip(ALL_AXES, np.unravel_index(
                self.rank, (pair, doppler, time)))}
        self.device = torch.device(device)
        self.backend = backend
        self._groups: Dict[Tuple[str, ...], object] = {}

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[_axis_tuple(axis)[0]]

    def axis_size(self, axes: _Axes) -> int:
        return math.prod(self.shape[a] for a in _axis_tuple(axes))

    def flat_index(self, axes: _Axes) -> int:
        """This rank's row-major index over ``axes`` (its position in
        :meth:`group`'s rank order)."""
        idx = 0
        for a in _axis_tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: _Axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes`` (the JAX collectives' axis names);
        group ranks run row-major over ``axes``."""
        names = _axis_tuple(axes)
        if names not in self._groups:
            sizes = [self.shape[a] for a in ALL_AXES]
            grid = np.arange(self.size).reshape(sizes)
            keep = [ALL_AXES.index(a) for a in names]
            rest = [i for i in range(3) if i not in keep]
            fibres = np.transpose(grid, rest + keep).reshape(
                -1, math.prod(sizes[i] for i in keep))
            mine = None
            for fibre in fibres:
                ranks = [int(r) for r in fibre]
                g = dist.new_group(ranks, backend=self.backend)
                if self.rank in ranks:
                    mine = g
            self._groups[names] = mine
        return self._groups[names]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({dims}; rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def mesh_device(device=None) -> torch.device:
    """The device a rank computes on: ``device`` when given, else
    ``cuda:{local_rank % device_count}``; without a card that raises
    (pass ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch sees no CUDA card; pass device=\"cpu\" to run the mesh on "
            "the CPU")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def make_mesh(pair: int = 1, doppler: int = 1, time: int = 1, *,
              device=None, collectives: Optional[str] = None) -> Mesh:
    """Build a ``(pair, doppler, time)`` mesh over the default process
    group (:func:`caf_cookoff_tpu_torch.parallel.multihost.
    initialize_cluster` forms it).

    Axis sizes must multiply to the world size.  ``device``: where this
    rank computes (see :func:`mesh_device`).  ``collectives``: the
    backend of the mesh's groups — ``nccl`` for a CUDA device and
    ``gloo`` for the CPU when not given.  Ranks that share one card must
    ask for ``gloo`` (NCCL refuses two ranks on one GPU).
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "parallel.multihost.initialize_cluster() (or "
            "torch.distributed.init_process_group) on every rank first")
    world = dist.get_world_size()
    want = pair * doppler * time
    if want != world:
        raise ValueError(
            f"mesh {pair}x{doppler}x{time} = {want} devices, got {world}")
    dev = mesh_device(device)
    if collectives is None:
        collectives = "nccl" if dev.type == "cuda" else "gloo"
    if collectives not in ("nccl", "gloo"):
        raise ValueError(f"unknown collectives backend {collectives!r}")
    if collectives == "nccl" and dev.type != "cuda":
        raise ValueError("nccl collectives need a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(pair, doppler, time, dev, collectives)


def default_mesh(batch: int = 1, *, device=None,
                 collectives: Optional[str] = None) -> Mesh:
    """Auto-factored mesh over the world: ``pair`` gets
    ``gcd(batch, n)``, the rest goes to ``doppler`` (the axis with no
    collectives during the surface build)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "parallel.multihost.initialize_cluster() first")
    n = dist.get_world_size()
    pair = math.gcd(batch, n) if batch > 1 else 1
    return make_mesh(pair=pair, doppler=n // pair, time=1, device=device,
                     collectives=collectives)


__all__ = ["ALL_AXES", "AXIS_DOPPLER", "AXIS_PAIR", "AXIS_TIME", "Mesh",
           "default_mesh", "factor_devices", "make_mesh", "mesh_device"]
