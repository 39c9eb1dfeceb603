"""caf_cookoff_tpu_torch — the PyTorch/CUDA port of the CAF engine.

The port of ``caf_cookoff_tpu`` to PyTorch on an NVIDIA H100: plain
tensor code in PyTorch (``torch.fft`` for every transform) and one
hand-written Hopper kernel, the fused Stein coarse rank
(``csrc/fused_stein.cu``).  Functions take numpy arrays or tensors and
an explicit ``device=`` (default: ``cuda`` when torch sees a card).

This slice covers the single-pair main path: ``caf_peak`` /
``caf_surface`` with the filterbank (``xla`` / ``matmul*`` names) and
the segmented engine (``stein``); ROADMAP.md lists what is still to be
ported.
"""

from caf_cookoff_tpu_torch.config import (BENCH_GRID, CafConfig, FreqGrid,
                                          default_device)
from caf_cookoff_tpu_torch.errors import (
    EligibilityError,
    EngineError,
    SpanError,
    VmemBudgetError,
)
from caf_cookoff_tpu_torch.models.filterbank import (
    FilterbankCAF,
    amb_surf,
    caf_peak,
    caf_surface,
    find_peak,
)
from caf_cookoff_tpu_torch.models.stein import (stein_caf_peak,
                                                stein_caf_surface)
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
    "VmemBudgetError",
    "amb_surf",
    "apply_fdoa",
    "caf_peak",
    "caf_surface",
    "default_device",
    "find_peak",
    "freq_shift",
    "phasor_bank",
    "stein_caf_peak",
    "stein_caf_surface",
    "xcor",
    "xcor_pair",
    "__version__",
]
