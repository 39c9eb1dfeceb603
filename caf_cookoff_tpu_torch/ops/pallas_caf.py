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
  for CPU tensors, all through :func:`_kernel_operands` and
  :func:`_launch`.  ``PEAK_LAUNCHES`` and ``SURFACE_LAUNCHES`` count the
  kernel launches.
* :func:`pallas_caf_peak` (tiers ``high``, ``bf16``, ``refine``) and
  :func:`pallas_caf_surface` (``high``, ``bf16``) are the engine entry
  points.  Every tier runs the same f32 transforms, at least as exact
  as the 3-pass and single-pass bf16 products the tiers name; ``refine``
  still re-scores its top ``TILE_BINS`` bins with a second launch, on
  the same haystack spectrum and rates.

The kernel's operands: H, the haystack's DFT by cuFFT (the plain large
transform outside the kernel, as the JAX package hoists it), gathered
into the order the kernel's threads hold the spectrum
(:func:`_h_order`, a cached index), and the rates, computed on the host
in numpy f32 for a host grid (bit for bit :func:`_rates`).  Each bin
takes a cluster of :func:`cluster_size` blocks, each holding M / C
points (at most ``BLOCK_LEN``); a row under 32 points is one thread's.
The card takes any power of two 2 <= M <= ``MAX_FFT_LEN``.  The TPU
kernel's bin padding to a multiple of 8 and needle padding to its DFT's
column factor are layout rules of its four-step DFT; the kernel here
takes any K and N.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.errors import EligibilityError, VmemBudgetError
from caf_cookoff_tpu_torch.ops.peak import CafPeak

TILE_BINS = 8       # candidate bins the refine tier re-scores
BLOCK_LEN = 8192    # most points of a row one block holds (64 KB)
MAX_CLUSTER = 16    # blocks a bin; past 8 a non-portable cluster size
# The largest row a cluster of blocks holds in shared memory; past it
# the card refuses (VmemBudgetError) and backend 'xla' runs any M.
MAX_FFT_LEN = BLOCK_LEN * MAX_CLUSTER

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


def _host_rates(freqs_hz, sample_rate) -> np.ndarray:
    """:func:`_rates` in numpy f32 on the host, bit for bit (each step
    one correctly rounded f32 product or quotient)."""
    f = np.asarray(freqs_hz).astype(np.float32)
    return (f * np.float32(2.0 * math.pi)) / np.float32(sample_rate)


def _kernel_rates(freqs_hz, sample_rate, device) -> torch.Tensor:
    """The rates on ``device``: one host-to-device copy for a host grid,
    :func:`_rates` on the card for a grid already there."""
    if isinstance(freqs_hz, torch.Tensor) and freqs_hz.device.type != "cpu":
        return _rates(freqs_hz, sample_rate, device)
    if isinstance(freqs_hz, torch.Tensor):
        freqs_hz = freqs_hz.numpy()
    return torch.from_numpy(_host_rates(freqs_hz, sample_rate)).to(device)


def _haystack_spectrum(haystack, m: int) -> torch.Tensor:
    """(M,) complex64 DFT of the zero-padded haystack, natural order."""
    return torch.fft.fft(haystack.to(torch.complex64), n=m)


def _rows_from(needle, h_spec, rates, m: int):
    """(K, M) complex64 unnormalised correlation rows, in torch.fft."""
    phase = rates[:, None] * torch.arange(needle.shape[-1],
                                          dtype=torch.float32,
                                          device=needle.device)
    nr, ni = needle.real, needle.imag
    cos, sin = torch.cos(phase), torch.sin(phase)
    shifted = torch.complex(nr * cos - ni * sin, nr * sin + ni * cos)
    s_spec = torch.fft.fft(shifted, n=m, dim=-1)
    return torch.fft.ifft(h_spec[None, :] * torch.conj(s_spec), dim=-1,
                          norm="forward")


def _plain_inputs(needle, haystack, freqs_hz, sample_rate, m: int):
    return (needle.to(torch.complex64), _haystack_spectrum(haystack, m),
            _rates(freqs_hz, sample_rate, needle.device))


def _rows_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    return _rows_from(*_plain_inputs(needle, haystack, freqs_hz,
                                     sample_rate, m), m)


def _mag2(rows: torch.Tensor) -> torch.Tensor:
    return rows.real * rows.real + rows.imag * rows.imag


def _plain(which: str, needle, h_spec, rates, m: int):
    """K2's (``which="peak"``) or K3's plain version from the complex64
    needle, H in natural order and the rates."""
    rows = _rows_from(needle, h_spec, rates, m)
    if which != "peak":
        return _mag2(rows) * (1.0 / m) ** 2
    vals, idxs = torch.max(_mag2(rows), dim=-1)   # first maximum on ties
    return vals, idxs.to(torch.int32)


def caf_peak_rows_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    """Plain PyTorch version of K2: ((K,) f32 per-bin max of the
    unnormalised ``|r_k|^2``, (K,) int32 lowest lag attaining it)."""
    return _plain("peak", *_plain_inputs(needle, haystack, freqs_hz,
                                         sample_rate, m), m)


def caf_surface_plain(needle, haystack, freqs_hz, sample_rate, m: int):
    """Plain PyTorch version of K3: (K, M) f32 ``|r_k|^2 / M^2``."""
    return _plain("surface", *_plain_inputs(needle, haystack, freqs_hz,
                                            sample_rate, m), m)


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


def _check_card_len(m: int):
    if m > MAX_FFT_LEN:
        raise VmemBudgetError(
            f"fused filterbank kernel: a {m}-point complex64 row does not "
            f"fit the shared memory of a cluster of {MAX_CLUSTER} blocks "
            f"(M <= {MAX_FFT_LEN}); use backend 'xla'")


def cluster_size(m: int) -> int:
    """Blocks a bin: the fewest that hold the row, M / ``BLOCK_LEN`` or 1.
    Splitting a row that one block holds was measured slower on the H100
    at every K (``utils/fb_study.py times``): each thread keeps 32
    points whatever the block's length, so a block's chain of passes
    does not shorten, and the cluster adds its phasor and cross-block
    steps."""
    return max(1, m // BLOCK_LEN)


def _block_plan(l: int):
    """(threads, log2 of the last pass's radix, passes) of a block of
    ``l`` points, as ``Shape<LOG_L>`` in the kernel has them: radix-16
    passes, then a last pass of radix 2^(log2 l mod 4), or 16.  Below 32
    points one thread holds the row: a single radix-``l`` pass."""
    log_l = l.bit_length() - 1
    if l < 32:
        return 1, log_l, 1
    log_rl = log_l % 4 or 4
    return l // 32, log_rl, 1 + (log_l - log_rl) // 4


def _spectrum_index(p: np.ndarray, l: int) -> np.ndarray:
    """The spectrum bin held at local position ``p`` after the kernel's
    forward passes (decimation in frequency: digit-reversed, the first
    pass's radix-16 digit lowest, the last pass's digit highest)."""
    _, log_rl, npass = _block_plan(l)
    log_s = l.bit_length() - 1
    f, rem, weight = np.zeros_like(p), p, 1
    for q in range(npass):
        log_s -= 4 if q < npass - 1 else log_rl
        f = f + weight * (rem >> log_s)
        rem = rem & ((1 << log_s) - 1)
        weight <<= 4
    return f


@functools.lru_cache(maxsize=32)
def _h_order(m: int, c: int) -> np.ndarray:
    """(M,) int64: the kernel's H is ``h[_h_order(m, c)]``.  Block k1 of
    a cluster holds bins k1 + C f; its thread t keeps, in the last
    forward pass, slot i of its u-th group of RL neighbours (position p =
    RL (t + T u) + i), stored slot-major at k1 L + (RL u + i) T + t so a
    warp reads it coalesced."""
    l = m // c
    t_n, log_rl, _ = _block_plan(l)
    q = np.arange(l)
    t, slot = q % t_n, q // t_n
    p = ((t + t_n * (slot >> log_rl)) << log_rl) + (slot & ((1 << log_rl)
                                                             - 1))
    f = _spectrum_index(p, l)
    return (np.arange(c)[:, None] + c * f[None, :]).reshape(-1)


@functools.lru_cache(maxsize=32)
def _h_index(m: int, c: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_h_order(m, c)).to(device)


def _twiddle_table(l: int) -> np.ndarray:
    """complex64 twiddles of a block's radix-16 passes, built in f64: for
    pass q, W_{L_q}^{jk}, L_q = l / 16^q, k = 1..15, j < L_q / 16,
    k-major, as the kernel's ``tw_offset`` lays them out (the last pass
    has none)."""
    _, _, npass = _block_plan(l)
    parts = []
    for q in range(npass - 1):
        sub = l >> (4 * q)
        jk = np.outer(np.arange(1, 16), np.arange(sub // 16))
        parts.append(np.exp(-2j * np.pi * jk / sub).reshape(-1))
    return np.concatenate([np.zeros(0), *parts]).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _twiddles(l: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_twiddle_table(l)).to(device)


def _h_kernel(h_spec, m: int, c: int) -> torch.Tensor:
    """H in the kernel's order for cluster size ``c``."""
    return h_spec[_h_index(m, c, h_spec.device)]


class _Operands(NamedTuple):
    """The inputs of one or more launches at one M, prepared once."""
    needle: torch.Tensor   # (N,) complex64, contiguous
    h: torch.Tensor        # (M,) H: natural order on the CPU, else kernel's
    rates: torch.Tensor    # (K,) f32
    c: int                 # blocks a bin (1 on the CPU)


def _kernel_operands(needle, haystack, freqs_hz, sample_rate,
                     m: int) -> _Operands:
    """H once (natural order on the CPU, the plain version's; on the card
    in the kernel's order for :func:`cluster_size` blocks a bin, after
    the card's limit is checked) and the rates."""
    dev = needle.device
    c = 1
    if dev.type != "cpu":
        _check_card_len(m)
        c = cluster_size(m)
    h = _haystack_spectrum(haystack, m)
    return _Operands(needle.to(torch.complex64).contiguous(),
                     h if dev.type == "cpu" else _h_kernel(h, m, c),
                     _kernel_rates(freqs_hz, sample_rate, dev), c)


def _run_kernel(which: str, needle, h_k, rates, c: int, m: int):
    """One launch of K2 (``which="peak"``) or K3 on prepared operands.
    The kernel launches on the calling thread's current device, so a
    tensor on another card switches to it first; the stream is read raw,
    with no Stream object built a launch."""
    from caf_cookoff_tpu_torch.ops import _build

    dev = needle.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _run_kernel(which, needle, h_k, rates, c, m)
    lib = _build.load_library()
    k = rates.shape[0]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (needle.data_ptr(), needle.shape[-1], h_k.data_ptr(),
            _twiddles(m // c, dev).data_ptr(), rates.data_ptr(), k, m, c)
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


def _launch(which: str, ops: _Operands, m: int):
    """K2 (``which="peak"``) or K3 on operands from
    :func:`_kernel_operands`: the plain version on the CPU, one counted
    launch on the card."""
    global PEAK_LAUNCHES, SURFACE_LAUNCHES
    if ops.needle.device.type == "cpu":
        return _plain(which, ops.needle, ops.h, ops.rates, m)
    out = _run_kernel(which, *ops, m)
    if which == "peak":
        PEAK_LAUNCHES += 1
    else:
        SURFACE_LAUNCHES += 1
    return out


def pallas_peak_rows(needle, haystack, freqs_hz, sample_rate, m: int):
    """K2: per-bin (max unnormalised ``|r_k|^2``, lowest lag), (K,) f32
    and (K,) int32.  CUDA tensors launch the kernel (a failed build or
    launch raises); CPU tensors run the plain version."""
    _check(needle, haystack, m)
    return _launch("peak", _kernel_operands(needle, haystack, freqs_hz,
                                            sample_rate, m), m)


def pallas_surface(needle, haystack, freqs_hz, sample_rate, m: int):
    """K3: the (K, M) f32 ``|r_k|^2 / M^2`` surface.  CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    _check(needle, haystack, m)
    return _launch("surface", _kernel_operands(needle, haystack, freqs_hz,
                                               sample_rate, m), m)


def _refined_peak(needle, haystack, freqs_hz, sample_rate, m: int):
    """Sweep every bin, re-score the top ``min(TILE_BINS, K)`` with a
    second launch on the same haystack spectrum and rates, and take the
    highest value; an exact tie goes to the lowest bin
    (``lexsort((cand, -vals2))`` in the JAX package)."""
    _check(needle, haystack, m)
    ops = _kernel_operands(needle, haystack, freqs_hz, sample_rate, m)
    vals, _ = _launch("peak", ops, m)
    # A stable descending sort keeps the lower bin first among equal
    # values, as lax.top_k does.
    cand = torch.sort(vals, descending=True, stable=True).indices[
        :min(TILE_BINS, vals.shape[0])]
    vals2, idxs2 = _launch("peak", ops._replace(rates=ops.rates[cand]), m)
    tied = vals2 == vals2.max()
    best = torch.argmin(torch.where(tied, cand, torch.iinfo(cand.dtype).max))
    return CafPeak(value=vals2[best], freq_idx=cand[best].to(torch.int32),
                   lag_idx=idxs2[best])


def pallas_caf_peak(needle, haystack, freqs_hz, sample_rate, fft_len: int,
                    precision: str = "high") -> CafPeak:
    """Global peak through K2: CafPeak(value, freq_idx, lag_idx), the
    value unnormalised (M^2 times the ``xla`` value)."""
    if precision not in ("high", "bf16", "refine"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "refine":
        return _refined_peak(needle, haystack, freqs_hz, sample_rate,
                             fft_len)
    vals, idxs = pallas_peak_rows(needle, haystack, freqs_hz, sample_rate,
                                  fft_len)
    best = torch.argmax(vals)                 # first maximum: lowest bin
    return CafPeak(value=vals[best], freq_idx=best.to(torch.int32),
                   lag_idx=idxs[best])


def pallas_caf_surface(needle, haystack, freqs_hz, sample_rate,
                       fft_len: int, precision: str = "high"):
    """(K, M) f32 surface through K3 (natural lag order, 1/M^2 scale)."""
    if precision not in ("high", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    return pallas_surface(needle, haystack, freqs_hz, sample_rate, fft_len)
