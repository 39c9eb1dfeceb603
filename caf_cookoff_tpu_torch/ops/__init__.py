"""Tensor ops: doppler shift, cross-correlation, peak extraction and the
fused Stein coarse rank (CUDA kernel + plain version)."""
