"""caf_cookoff_tpu_torch — the PyTorch/CUDA port of the CAF engine.

The port of ``caf_cookoff_tpu`` to PyTorch on an NVIDIA H100: plain
tensor code in PyTorch (``torch.fft`` for the FFT backends) and
hand-written Hopper kernels built by nvcc at first use: the fused Stein
coarse rank (``csrc/fused_stein.cu``, K1), the fused filterbank peak
rows and surface (``csrc/caf_filterbank.cu``, K2 and K3) and the
|R|^2/max epilogue microbenchmark (``csrc/roofline_epilogue.cu``, K4,
``utils/roofline``).  Functions
take numpy arrays or tensors; they run on the CUDA card unless
``device="cpu"`` asks for the CPU (without a card and without that
request they raise).

Ported so far: the single-pair paths ``caf_peak`` / ``caf_surface`` with
the filterbank (``xla`` / ``matmul*``), the fused filterbank (``pallas``,
``pallas-refine``, ``pallas-bf16``) and the segmented engine (``stein``,
banded for wide spans); the batch engines (``batched_caf_peak`` /
``batched_caf_surface``, ``batched_stein_peak``); the long-capture
engines (``overlap_save_peak`` / ``overlap_save_surface``,
``stein_overlap_save_peak``, ``batched_stein_os_peak``); the
multi-emitter lattices and detection (``find_peaks``, ``merge_peaks``,
``resolution_cell``, ``detection_threshold_db``,
``apply_detection_threshold``, ``overlap_save_peaks``,
``batched_overlap_save_peaks_local``, ``batched_stein_peaks``,
``batched_stein_os_peaks``); the rate engines (``rate_caf_peak``,
``rate_overlap_save_peak[s]``, ``stein_rate_os_peak[s]``) and the zoom
refinement (``refine_peak``, ``refine_peak_rate``, ``refine_peaks``);
the chunk-at-a-time engine ``StreamingCAF`` (cuFFT steps, or K1 once a
chunk with ``backend="stein"``); and the CLI verbs ``generate``, ``run``
(with ``--full-haystack``, ``--num-peaks``, ``--refine``, ``--rate``,
``--rate-grid``, ``--dump-surface``, ``--plot`` and ``--annotate``),
``stream``, ``capture``, ``batch`` (with ``--refine``), ``bench``,
``selftest`` and ``info``, with the utilities behind them
(``utils/profiling``, ``utils/pulses``, ``utils/native``); and
``parallel/``: meshes over ``torch.distributed`` (one process a
device), the peak collectives and the sharded engines, K1 in each shard
of the fused ones, with ``parallel.multihost`` to start the processes.
Every module of the JAX package has its counterpart.
"""

from caf_cookoff_tpu_torch.config import (BENCH_GRID, CafConfig, FreqGrid,
                                          default_device)
from caf_cookoff_tpu_torch.errors import (
    EligibilityError,
    EngineError,
    SpanError,
    VmemBudgetError,
)
from caf_cookoff_tpu_torch.models.batched import (batched_caf_peak,
                                                  batched_caf_surface)
from caf_cookoff_tpu_torch.models.batched_stein import (
    batched_stein_os_peak,
    batched_stein_os_peaks,
    batched_stein_peak,
    batched_stein_peaks,
)
from caf_cookoff_tpu_torch.models.filterbank import (
    FilterbankCAF,
    amb_surf,
    caf_peak,
    caf_surface,
    find_peak,
)
from caf_cookoff_tpu_torch.models.overlap_save import (
    batched_overlap_save_peaks_local,
    overlap_save_peak,
    overlap_save_peaks,
    overlap_save_surface,
)
from caf_cookoff_tpu_torch.models.rate import (rate_caf_peak,
                                               rate_overlap_save_peak,
                                               rate_overlap_save_peaks,
                                               stein_rate_os_peak,
                                               stein_rate_os_peaks)
from caf_cookoff_tpu_torch.models.stein import (stein_caf_peak,
                                                stein_caf_surface,
                                                stein_overlap_save_peak)
from caf_cookoff_tpu_torch.models.streaming import StreamingCAF
from caf_cookoff_tpu_torch.ops.peak import (
    apply_detection_threshold,
    detection_threshold_db,
    find_peaks,
    merge_peaks,
    resolution_cell,
)
from caf_cookoff_tpu_torch.ops.refine import (refine_peak, refine_peak_rate,
                                              refine_peaks)
from caf_cookoff_tpu_torch.ops.shift import apply_fdoa, freq_shift, phasor_bank
from caf_cookoff_tpu_torch.ops.xcor import xcor, xcor_pair

__version__ = "0.1.0"

__all__ = [
    "BENCH_GRID",
    "CafConfig",
    "EligibilityError",
    "EngineError",
    "FilterbankCAF",
    "FreqGrid",
    "SpanError",
    "StreamingCAF",
    "VmemBudgetError",
    "amb_surf",
    "apply_detection_threshold",
    "apply_fdoa",
    "batched_caf_peak",
    "batched_caf_surface",
    "batched_overlap_save_peaks_local",
    "batched_stein_os_peak",
    "batched_stein_os_peaks",
    "batched_stein_peak",
    "batched_stein_peaks",
    "caf_peak",
    "caf_surface",
    "default_device",
    "detection_threshold_db",
    "find_peak",
    "find_peaks",
    "freq_shift",
    "merge_peaks",
    "overlap_save_peak",
    "overlap_save_peaks",
    "overlap_save_surface",
    "phasor_bank",
    "rate_caf_peak",
    "rate_overlap_save_peak",
    "rate_overlap_save_peaks",
    "refine_peak",
    "refine_peak_rate",
    "refine_peaks",
    "resolution_cell",
    "stein_caf_peak",
    "stein_caf_surface",
    "stein_overlap_save_peak",
    "stein_rate_os_peak",
    "stein_rate_os_peaks",
    "xcor",
    "xcor_pair",
    "__version__",
]
