"""Tensor ops: doppler shift, cross-correlation, peak extraction and the
fused Stein coarse rank (CUDA kernel + plain version).  Re-exports the
JAX package's ``ops`` names."""

from caf_cookoff_tpu_torch.ops.peak import find_peak_2d, surface_peak
from caf_cookoff_tpu_torch.ops.shift import apply_fdoa, freq_shift, phasor_bank
from caf_cookoff_tpu_torch.ops.xcor import xcor, xcor_bank, xcor_pair

__all__ = [
    "apply_fdoa",
    "find_peak_2d",
    "freq_shift",
    "phasor_bank",
    "surface_peak",
    "xcor",
    "xcor_bank",
    "xcor_pair",
]
