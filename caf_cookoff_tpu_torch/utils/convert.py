"""Carry the JAX package's state into the port's tensors.

The system has no weights: its state is signal data and the Stein
engine's operands.  The JAX package keeps complex values as split
(re, im) float planes and builds the kernel operands with
``_needle_operator``, ``_haystack_extension`` and
``stein_synthesis_weights``; these helpers take those arrays as numpy
(``np.asarray`` of a ``jax.Array``) and return the port's tensors, so a
test can feed both packages the same operands.  Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import CafConfig, FreqGrid, default_device


def _device(device, like=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return default_device()


def as_signal(x, device=None) -> torch.Tensor:
    """A complex signal tensor on ``device`` from numpy, a list or a
    tensor.  complex64/complex128 keep their precision; real input
    becomes complex with a zero imaginary part.  An empty signal raises
    ``ValueError``."""
    dev = _device(device, x)
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(np.asarray(x))
        # torch.from_numpy shares memory: a read-only buffer (a memory
        # map, np.frombuffer) is copied first.
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError("empty signal (zero-length last axis)")
    if not x.is_complex():
        x = x.to(torch.float64 if x.dtype == torch.float64
                 else torch.float32)
        x = torch.complex(x, torch.zeros_like(x))
    return x.to(dev)


def split_to_complex(re, im, device=None) -> torch.Tensor:
    """Split-complex planes (numpy) -> one complex tensor (complex64 for
    float32 planes, complex128 for float64)."""
    re = torch.from_numpy(np.ascontiguousarray(re))
    im = torch.from_numpy(np.ascontiguousarray(im))
    if re.shape != im.shape:
        raise ValueError(f"plane shapes differ: {tuple(re.shape)} vs "
                         f"{tuple(im.shape)}")
    return torch.complex(re, im).to(_device(device))


def stein_operands_from_numpy(ws1, ws2, lmat, h_ext, device=None):
    """The fused Stein kernel's operands (``ws1``, ``ws2`` (K, 2B);
    ``lmat`` (P, 2B, 2D); ``h_ext`` (P, 2, span+127)) as contiguous
    float32 tensors on ``device``, values unchanged."""
    dev = _device(device)
    return tuple(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        for a in (ws1, ws2, lmat, h_ext))


def caf_config_from_jax(cfg):
    """A JAX ``CafConfig`` or ``FreqGrid`` -> the port's, from its
    fields."""
    if hasattr(cfg, "step_hz"):
        return FreqGrid(float(cfg.start_hz), float(cfg.stop_hz),
                        float(cfg.step_hz))
    return CafConfig(sample_rate=float(cfg.sample_rate),
                     grid=caf_config_from_jax(cfg.grid),
                     precision=str(cfg.precision),
                     backend=str(cfg.backend))
