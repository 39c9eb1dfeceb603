"""CAF engines (the JAX package's ``models`` layer): the filterbank, the
segmented (Stein) engine, the batched, overlap-save, rate and streaming
engines.  Re-exports the JAX package's ``models`` names."""

from caf_cookoff_tpu_torch.models.filterbank import (FilterbankCAF, amb_surf,
                                                     caf_peak, caf_surface,
                                                     find_peak)
from caf_cookoff_tpu_torch.models.overlap_save import (overlap_save_peak,
                                                       overlap_save_surface)
from caf_cookoff_tpu_torch.models.stein import (stein_caf_peak,
                                                stein_caf_surface,
                                                stein_overlap_save_peak)

__all__ = [
    "FilterbankCAF",
    "amb_surf",
    "caf_peak",
    "caf_surface",
    "find_peak",
    "overlap_save_peak",
    "overlap_save_surface",
    "stein_caf_peak",
    "stein_caf_surface",
    "stein_overlap_save_peak",
]
