"""Utilities: signal I/O, fixture generation, JAX-package conversion.
Re-exports the JAX package's ``utils`` names."""

from caf_cookoff_tpu_torch.utils.io import (dump_surf, load_c64, load_f32,
                                            parse_ground_truth, write_c64,
                                            write_c128)

__all__ = [
    "dump_surf",
    "load_c64",
    "load_f32",
    "parse_ground_truth",
    "write_c64",
    "write_c128",
]
