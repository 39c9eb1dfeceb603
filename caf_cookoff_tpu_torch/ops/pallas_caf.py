"""Fused CAF filterbank kernels: K2 (per-bin peak) and K3 (surface).

The counterpart of the JAX package's ``ops/pallas_caf``.  Per doppler
bin k, with ``rate_k = (2*pi*f32(f_k)) / f32(fs)`` in f32:

    s_k[n] = needle[n] * exp(j * rate_k * n)   (n < N, zeros up to M)
    r_k    = IDFT(H * conj(DFT(s_k)))          (inverse unnormalised)

K2 returns ``max_tau |r_k|^2`` and the lowest lag attaining it, so its
values are M^2 times those of the normalised ``xla`` rows; K3 returns
``|r_k|^2 / M^2`` in natural lag order, the ``xla`` surface.

* :func:`pallas_peak_rows` / :func:`pallas_surface` launch
  ``csrc/caf_filterbank.cu`` for CUDA tensors (or raise) and run the
  plain versions :func:`caf_peak_rows_plain` / :func:`caf_surface_plain`
  for CPU tensors.  ``PEAK_LAUNCHES`` and ``SURFACE_LAUNCHES`` count the
  kernel launches.
* :func:`pallas_caf_peak` (tiers ``high``, ``bf16``, ``refine``) and
  :func:`pallas_caf_surface` (``high``, ``bf16``) are the engine entry
  points.  Every tier runs the same f32 transforms, at least as exact
  as the 3-pass and single-pass bf16 products the tiers name; ``refine``
  still re-scores its top ``TILE_BINS`` bins with a second launch.

The TPU kernel's bin padding to a multiple of 8 and its needle padding
to the DFT's column factor are layout rules of its four-step DFT; one
block per bin takes any K and N here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError
from caf_cookoff_tpu_torch.ops.peak import CafPeak

TILE_BINS = 8       # candidate bins the refine tier re-scores
# The largest power-of-two row whose M complex64 values (+128 B of K2's
# reduction slots) fit the 232,448 B of shared memory a Hopper block may
# use.
MAX_FFT_LEN = 16_384

PEAK_LAUNCHES = 0
SURFACE_LAUNCHES = 0


def _rates(freqs_hz, sample_rate, device) -> torch.Tensor:
    """(K,) f32 ``(2*pi*f32(f)) / f32(fs)``, in the TPU kernel's order."""
    f = torch.as_tensor(freqs_hz, device=device).to(torch.float32)
    two_pi_f = f * float(np.float32(2.0 * math.pi))
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently.
    return two_pi_f / torch.full_like(two_pi_f,
                                      float(np.float32(sample_rate)))


def _rows_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    """(K, M) complex64 unnormalised correlation rows, in torch.fft."""
    dev = needle.device
    needle = needle.to(torch.complex64)
    rates = _rates(freqs_hz, sample_rate, dev)
    phase = rates[:, None] * torch.arange(needle.shape[-1],
                                          dtype=torch.float32, device=dev)
    nr, ni = needle.real, needle.imag
    cos, sin = torch.cos(phase), torch.sin(phase)
    shifted = torch.complex(nr * cos - ni * sin, nr * sin + ni * cos)
    s_spec = torch.fft.fft(shifted, n=m, dim=-1)
    h_spec = torch.fft.fft(haystack.to(torch.complex64), n=m)
    return torch.fft.ifft(h_spec[None, :] * torch.conj(s_spec), dim=-1,
                          norm="forward")


def _mag2(rows: torch.Tensor) -> torch.Tensor:
    return rows.real * rows.real + rows.imag * rows.imag


def caf_peak_rows_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    """Plain PyTorch version of K2: ((K,) f32 per-bin max of the
    unnormalised ``|r_k|^2``, (K,) int32 lowest lag attaining it)."""
    vals, idxs = torch.max(
        _mag2(_rows_plain(needle, haystack, freqs_hz, sample_rate, m)),
        dim=-1)                                # first maximum on ties
    return vals, idxs.to(torch.int32)


def caf_surface_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    """Plain PyTorch version of K3: (K, M) f32 ``|r_k|^2 / M^2``."""
    return _mag2(_rows_plain(needle, haystack, freqs_hz, sample_rate,
                             m)) * (1.0 / m) ** 2


def _check(needle, haystack, m: int):
    if not (needle.is_complex() and haystack.is_complex()):
        raise TypeError("the filterbank kernels take complex signals")
    if needle.device != haystack.device:
        raise ValueError(f"needle on {needle.device}, haystack on "
                         f"{haystack.device}")
    if m < 2 or m & (m - 1):
        raise EligibilityError(f"fused filterbank needs a power-of-two "
                               f"correlation length, got {m}")
    if 2 * needle.shape[-1] > m or haystack.shape[-1] > m:
        raise ValueError(f"needle {needle.shape[-1]} / haystack "
                         f"{haystack.shape[-1]} too long for M = {m}")
    if needle.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {needle.device}")


@functools.lru_cache(maxsize=16)
def _tables(m: int, device: torch.device):
    """(bit-reversal permutation (M,) int64, twiddles exp(-2 pi i j / M),
    j < M/2, built in f64 and stored as complex64), on ``device``."""
    bits = m.bit_length() - 1
    idx = np.arange(m)
    rev = np.zeros(m, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    tw = np.exp(-2j * np.pi * np.arange(m // 2) / m).astype(np.complex64)
    return (torch.from_numpy(rev).to(device),
            torch.from_numpy(tw).to(device))


def _kernel_operands(needle, haystack, freqs_hz, sample_rate, m: int):
    """The kernel's inputs on the signals' card: (needle complex64, H in
    bit-reversed order, twiddles, rates)."""
    if m > MAX_FFT_LEN:
        raise VmemBudgetError(
            f"fused filterbank kernel: a {m}-point complex64 row does not "
            f"fit one block's shared memory (M <= {MAX_FFT_LEN}); use "
            f"backend 'xla'")
    rev, tw = _tables(m, needle.device)
    h_br = torch.fft.fft(haystack.to(torch.complex64), n=m)[rev]
    return (needle.to(torch.complex64).contiguous(), h_br.contiguous(), tw,
            _rates(freqs_hz, sample_rate, needle.device).contiguous())


def _run_kernel(which: str, needle, h_br, tw, rates, m: int):
    """One launch of K2 (``which="peak"``) or K3 on prepared operands."""
    from caf_cookoff_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = needle.device
    k = rates.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (needle.data_ptr(), needle.shape[-1], h_br.data_ptr(),
            tw.data_ptr(), rates.data_ptr(), k, m)
    with torch.cuda.device(dev):
        if which == "peak":
            vals = torch.empty(k, dtype=torch.float32, device=dev)
            idxs = torch.empty(k, dtype=torch.int32, device=dev)
            rc = lib.caf_filterbank_peak(*args, vals.data_ptr(),
                                         idxs.data_ptr(), stream)
            out = (vals, idxs)
        else:
            out = torch.empty((k, m), dtype=torch.float32, device=dev)
            rc = lib.caf_filterbank_surface(*args, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused filterbank kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    return out


def pallas_peak_rows(needle, haystack, freqs_hz, sample_rate, m: int):
    """K2: per-bin (max unnormalised ``|r_k|^2``, lowest lag), (K,) f32
    and (K,) int32.  CUDA tensors launch the kernel (a failed build or
    launch raises); CPU tensors run :func:`caf_peak_rows_plain`."""
    global PEAK_LAUNCHES
    _check(needle, haystack, m)
    if needle.device.type == "cpu":
        return caf_peak_rows_plain(needle, haystack, freqs_hz, sample_rate,
                                   m)
    out = _run_kernel("peak", *_kernel_operands(
        needle, haystack, freqs_hz, sample_rate, m), m)
    PEAK_LAUNCHES += 1
    return out


def pallas_surface(needle, haystack, freqs_hz, sample_rate, m: int):
    """K3: the (K, M) f32 ``|r_k|^2 / M^2`` surface.  CUDA tensors launch
    the kernel (or raise); CPU tensors run :func:`caf_surface_plain`."""
    global SURFACE_LAUNCHES
    _check(needle, haystack, m)
    if needle.device.type == "cpu":
        return caf_surface_plain(needle, haystack, freqs_hz, sample_rate, m)
    out = _run_kernel("surface", *_kernel_operands(
        needle, haystack, freqs_hz, sample_rate, m), m)
    SURFACE_LAUNCHES += 1
    return out


def _refined_peak(needle, haystack, freqs_hz, sample_rate, m: int):
    """Sweep every bin, re-score the top ``min(TILE_BINS, K)`` with a
    second launch and take the highest value; an exact tie goes to the
    lowest bin (``lexsort((cand, -vals2))`` in the JAX package)."""
    vals, _ = pallas_peak_rows(needle, haystack, freqs_hz, sample_rate, m)
    # A stable descending sort keeps the lower bin first among equal
    # values, as lax.top_k does.
    cand = torch.sort(vals, descending=True, stable=True).indices[
        :min(TILE_BINS, vals.shape[0])]
    vals2, idxs2 = pallas_peak_rows(needle, haystack, freqs_hz[cand],
                                    sample_rate, m)
    tied = vals2 == vals2.max()
    best = torch.argmin(torch.where(tied, cand, torch.iinfo(cand.dtype).max))
    return CafPeak(value=vals2[best], freq_idx=cand[best].to(torch.int32),
                   lag_idx=idxs2[best])


def pallas_caf_peak(needle, haystack, freqs_hz, sample_rate, fft_len: int,
                    precision: str = "high") -> CafPeak:
    """Global peak through K2: CafPeak(value, freq_idx, lag_idx), the
    value unnormalised (M^2 times the ``xla`` value).  ``freqs_hz`` is
    taken to the signals' device."""
    if precision not in ("high", "bf16", "refine"):
        raise ValueError(f"unknown precision {precision!r}")
    freqs = torch.as_tensor(freqs_hz, device=needle.device)
    if precision == "refine":
        return _refined_peak(needle, haystack, freqs, sample_rate, fft_len)
    vals, idxs = pallas_peak_rows(needle, haystack, freqs, sample_rate,
                                  fft_len)
    best = torch.argmax(vals)                 # first maximum: lowest bin
    return CafPeak(value=vals[best], freq_idx=best.to(torch.int32),
                   lag_idx=idxs[best])


def pallas_caf_surface(needle, haystack, freqs_hz, sample_rate,
                       fft_len: int, precision: str = "high"):
    """(K, M) f32 surface through K3 (natural lag order, 1/M^2 scale)."""
    if precision not in ("high", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    return pallas_surface(needle, haystack,
                          torch.as_tensor(freqs_hz, device=needle.device),
                          sample_rate, fft_len)
