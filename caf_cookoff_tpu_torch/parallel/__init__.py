"""Multi-device parallelism over ``torch.distributed``: meshes,
collectives and the sharded CAF engines.

The port of ``caf_cookoff_tpu/parallel``: named mesh axes (``pair``,
``doppler``, ``time``) over the ranks of the default process group, one
process per device (SPMD), collectives on NCCL for cards or gloo for the
CPU (explicit), halos sliced from each rank's copy of the capture, and
the ``MAX``/``MIN`` peak reduction and two-collective lattice gathers of
the JAX package.  ``multihost.initialize_cluster`` forms the group.
"""

from caf_cookoff_tpu_torch.parallel.collectives import (
    global_peak,
    global_peaks,
    global_peaks_batched,
)
from caf_cookoff_tpu_torch.parallel.mesh import (
    AXIS_DOPPLER,
    AXIS_PAIR,
    AXIS_TIME,
    default_mesh,
    factor_devices,
    make_mesh,
)
from caf_cookoff_tpu_torch.parallel.sharded import (
    batched_caf_peak,
    batched_overlap_save_peak,
    batched_overlap_save_peaks,
    estimate_hbm_per_chip,
    sharded_batched_stein_os_peaks,
    sharded_batched_stein_peak,
    sharded_batched_stein_peaks,
    sharded_caf_peak,
    sharded_caf_surface,
    sharded_overlap_save_peak,
    sharded_overlap_save_peaks,
    sharded_rate_overlap_save_peak,
    sharded_rate_overlap_save_peaks,
    sharded_stein_os_peak,
    sharded_stein_os_peaks,
    sharded_stein_peak,
    sharded_stein_rate_os_peak,
)

__all__ = [
    "AXIS_DOPPLER",
    "AXIS_PAIR",
    "AXIS_TIME",
    "batched_caf_peak",
    "batched_overlap_save_peak",
    "batched_overlap_save_peaks",
    "default_mesh",
    "estimate_hbm_per_chip",
    "factor_devices",
    "global_peak",
    "global_peaks",
    "global_peaks_batched",
    "make_mesh",
    "sharded_batched_stein_peak",
    "sharded_batched_stein_os_peaks",
    "sharded_batched_stein_peaks",
    "sharded_stein_os_peak",
    "sharded_stein_os_peaks",
    "sharded_stein_rate_os_peak",
    "sharded_caf_peak",
    "sharded_caf_surface",
    "sharded_overlap_save_peak",
    "sharded_overlap_save_peaks",
    "sharded_rate_overlap_save_peak",
    "sharded_rate_overlap_save_peaks",
    "sharded_stein_peak",
]
