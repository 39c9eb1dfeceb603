"""Streaming CAF — a long or unbounded capture processed chunk by chunk.

The engine keeps the ``N-1`` tail samples of each chunk, so correlations
that straddle a chunk boundary are never lost, and carries the running
global peak (or a top-P lattice) with absolute lag indices.  The state
stays on the engine's device between chunks: the tail, the running
best, the carried re-score windows, the floor sums and the window's
base lag (int32, as the JAX package traces it).

Each chunk runs one step, a plain function of tensors and static ints:

* cuFFT steps (:func:`_stream_step`, :func:`_stream_lattice_step`): the
  window ``[tail | chunk]`` through ``models/overlap_save.streaming_peak``
  (its block loop, with the floor accumulators), lags
  ``[base_lag, base_lag + chunk_len)`` masked past the chunk's valid
  length;
* Stein steps (:func:`_stein_stream_step`,
  :func:`_stein_stream_lattice_step`): the window through one
  ``ops/fused_stein.fused_stein_rank`` call at P = 1 with ``num_valid``
  (K1), or with K1's top-2 mode (e) at ``sep = exclude_lag`` for a
  lattice; each carries a guard-extended window slice around its
  candidate, which :meth:`StreamingCAF.best` / :meth:`StreamingCAF.peaks`
  re-score with exact filterbank rows (:func:`_stein_lattice_rescore`).

The base lag and the valid length are tensors, so a step reads nothing
back and one compiled call (``ops/_graph``: one CUDA graph per static
key on a card, as JAX jits each step) serves every chunk of a stream.
Each step returns ``(*best, *carry, tail, base_lag + valid, local)``:
the running best's three fields, two carried tensors (the floor sums,
or the re-score window and its start), the next tail, the next base lag
and this chunk's peak packed as one (3,) f64 tensor.

On a CUDA device the Stein steps launch K1 (a failed build or launch
raises); on the CPU K1 runs its plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from caf_cookoff_tpu_torch.config import as_grid, resolve_backend, xcor_length
from caf_cookoff_tpu_torch.models.batched_stein import (_as_tensor, _host,
                                                        _needle_operator,
                                                        _pack,
                                                        _pow2_block_len)
from caf_cookoff_tpu_torch.models.filterbank import _surface_rows, mag2
from caf_cookoff_tpu_torch.models.overlap_save import (needle_spectra_conj,
                                                       streaming_peak)
from caf_cookoff_tpu_torch.ops import _graph
from caf_cookoff_tpu_torch.ops.fused_stein import (SUPER, check_kernel_shape,
                                                   fused_span,
                                                   fused_stein_rank,
                                                   stein_synthesis_weights)
from caf_cookoff_tpu_torch.ops.peak import (CafPeak, apply_detection_threshold,
                                            concat_peaks, find_peak_2d,
                                            merge_peaks, resolve_exclusions)
from caf_cookoff_tpu_torch.ops.xcor import pad_to
from caf_cookoff_tpu_torch.utils.convert import as_signal
from caf_cookoff_tpu_torch.utils.profiling import recording, span

# Guard samples on EACH side of a carried re-score window: the Stein
# steps slice the window so the winning lag sits ~_RESCORE_GUARD samples
# in, and size the carry to needle_pad + _RESCORE_PAD — the steps, the
# carry buffers and the re-score lag bound (max_lag = needle_pad +
# _RESCORE_PAD - needle_len) must all agree on this number, so it lives
# here and nowhere else.
_RESCORE_GUARD = 64
_RESCORE_PAD = 2 * _RESCORE_GUARD
_INT32_MAX = 2 ** 31 - 1


def _take(take: torch.Tensor, new: CafPeak, old: CafPeak) -> CafPeak:
    """The running best: ``new`` where ``take``, else ``old``."""
    return CafPeak(*(torch.where(take, a, b) for a, b in zip(new, old)))


def _next_tail(window: torch.Tensor, num_valid: torch.Tensor,
               halo: int) -> torch.Tensor:
    """``window[valid:valid + halo]`` gathered on the device (JAX's
    ``dynamic_slice``): the next tail ends at the last valid sample."""
    idx = num_valid.long() + torch.arange(halo, device=window.device)
    return window.index_select(-1, idx)


def _stream_step(s_conj, tail, chunk, best_value, best_freq, best_lag,
                 fsum, fcnt, base_lag, num_valid, needle_len: int):
    """One cuFFT step: correlate ``[tail | chunk]``, update the best.

    The window covers lags ``[base_lag, base_lag + chunk_len)``: each new
    sample admits one new lag, so consecutive windows tile the capture's
    lag axis.  Lags past ``num_valid`` (a zero-padded short chunk) are
    masked; ``fsum``/``fcnt`` gain this window's valid cells."""
    window = torch.cat([tail, chunk])
    total = base_lag + num_valid[0]
    local, wsum, wcnt = streaming_peak(
        s_conj, window, needle_len, chunk.shape[-1], lag_offset=base_lag,
        total_lags=total, with_floor=True)
    best = _take(local.value > best_value, local,
                 CafPeak(best_value, best_freq, best_lag))
    return (*best, fsum + wsum, fcnt + wcnt,
            _next_tail(window, num_valid, needle_len - 1), total,
            _pack(local))


def _stream_lattice_step(s_conj, tail, chunk, best_value, best_freq,
                         best_lag, fsum, fcnt, base_lag, num_valid,
                         needle_len: int, num_peaks: int, exclude_freq: int,
                         exclude_lag: int):
    """The multi-emitter cuFFT step: this window's top-``num_peaks``
    lattice NMS-merged into the running one, so an emitter whose skirt
    leaks into the next window is counted once; ``local`` is the
    window's strongest entry."""
    window = torch.cat([tail, chunk])
    total = base_lag + num_valid[0]
    local, wsum, wcnt = streaming_peak(
        s_conj, window, needle_len, chunk.shape[-1], lag_offset=base_lag,
        total_lags=total, num_peaks=num_peaks, exclude_freq=exclude_freq,
        exclude_lag=exclude_lag, with_floor=True)
    merged = merge_peaks(
        concat_peaks(CafPeak(best_value, best_freq, best_lag), local),
        num_peaks, exclude_freq, exclude_lag)
    return (*merged, fsum + wsum, fcnt + wcnt,
            _next_tail(window, num_valid, needle_len - 1), total,
            _pack(CafPeak(*(x[0] for x in local))))


def stein_window_operand(tail, chunk, num_blocks: int, group: int):
    """The window ``[tail | chunk]`` and K1's (1, 2, span + SUPER - 1)
    haystack extension of it (its real and imaginary planes, padded)."""
    window = torch.cat([tail, chunk])
    need = fused_span(num_blocks, group, chunk.shape[-1]) + SUPER - 1
    planes = torch.stack([window.real, window.imag])
    return window, pad_to(planes, max(need, window.shape[-1]))[None, :, :need]


def _stein_window(ws1, ws2, lmat, tail, chunk, num_blocks: int, group: int,
                  num_valid: torch.Tensor, carry: int, **top2):
    """K1 over ``[tail | chunk]`` at P = 1: returns (window zero-padded to
    hold a carry slice anywhere, K1's outputs).  ``num_valid`` bounds the
    scanned lags inside the kernel: masking the per-bin (max, argmax)
    after it would drop a bin's valid peak with a padded-region shadow."""
    window, h_ext = stein_window_operand(tail, chunk, num_blocks, group)
    out = fused_stein_rank(ws1, ws2, lmat, h_ext, num_blocks, group,
                           chunk.shape[-1], num_valid=num_valid, **top2)
    return pad_to(window, max(window.shape[-1], carry)), out


def _carry_slices(wpad: torch.Tensor, tau_loc: torch.Tensor, carry: int):
    """Slices of ``carry`` samples starting ``_RESCORE_GUARD`` before each
    window-local lag ``tau_loc`` (clipped into the window), gathered on
    the device: ``(slices (..., carry), starts (...))``."""
    starts = torch.clamp(tau_loc - _RESCORE_GUARD, 0, wpad.shape[-1] - carry)
    idx = starts[..., None] + torch.arange(carry, device=wpad.device)
    return wpad[idx], starts


def _stein_stream_step(ws1, ws2, lmat, tail, chunk, best_value, best_freq,
                       best_lag, bw, bw_start, base_lag, num_valid,
                       num_blocks: int, group: int, needle_len: int,
                       carry: int):
    """One Stein step: K1 over ``[tail | chunk]``, the bin argmax (the
    lowest bin on ties), the running best, and — where this window's
    peak wins — its carried window slice for :meth:`StreamingCAF.best`'s
    exact re-score."""
    wpad, (vals, idxs) = _stein_window(ws1, ws2, lmat, tail, chunk,
                                       num_blocks, group, num_valid, carry)
    vals = vals[:, 0]
    # A (1,) index: a 0-d tensor index would be read back to the host.
    k_loc = torch.argmax(vals).reshape(1)
    tau_loc = idxs[:, 0].index_select(0, k_loc)[0]
    local = CafPeak(vals.index_select(0, k_loc)[0], k_loc[0].to(torch.int32),
                    tau_loc + base_lag)
    take = local.value > best_value
    cand, start = _carry_slices(wpad, tau_loc, carry)
    best = _take(take, local, CafPeak(best_value, best_freq, best_lag))
    return (*best, torch.where(take, cand, bw),
            torch.where(take, start + base_lag, bw_start),
            _next_tail(wpad, num_valid, needle_len - 1),
            base_lag + num_valid[0], _pack(local))


def _stein_stream_lattice_step(ws1, ws2, lmat, tail, chunk, best_value,
                               best_freq, best_lag, bws, bw_starts, base_lag,
                               num_valid, num_blocks: int, group: int,
                               needle_len: int, carry: int, num_peaks: int,
                               exclude_freq: int, exclude_lag: int):
    """The multi-emitter Stein step: K1's top-2 mode (e) gives two lag
    candidates a bin more than ``exclude_lag`` apart (exact for any pair
    past ``sep``); both slots fold into this window's NMS lattice, each
    entry gathers its own window slice, and the lattice merges into the
    carried one with the slices following their entries; ``local`` is
    the window's strongest entry."""
    wpad, (vals, idxs, vals2, idxs2) = _stein_window(
        ws1, ws2, lmat, tail, chunk, num_blocks, group, num_valid, carry,
        want_top2=True, sep=exclude_lag)
    bins = torch.arange(vals.shape[0], dtype=torch.int32, device=vals.device)
    # Slot 2's sentinel (-1.0: no separated second candidate) becomes
    # -inf, which the merge can neither keep nor suppress with.
    v2 = torch.where(vals2[:, 0] < 0, -math.inf, vals2[:, 0])
    cands = CafPeak(torch.cat([vals[:, 0], v2]), torch.cat([bins, bins]),
                    torch.cat([idxs[:, 0], idxs2[:, 0]]) + base_lag)
    chunk_lat = merge_peaks(cands, num_peaks, exclude_freq, exclude_lag)
    chunk_bws, starts = _carry_slices(wpad, chunk_lat.lag_idx - base_lag,
                                      carry)
    merged, sel = merge_peaks(
        concat_peaks(CafPeak(best_value, best_freq, best_lag), chunk_lat),
        num_peaks, exclude_freq, exclude_lag, return_indices=True)
    sel = sel.long()
    return (*merged, torch.cat([bws, chunk_bws])[sel],
            torch.cat([bw_starts, starts + base_lag])[sel],
            _next_tail(wpad, num_valid, needle_len - 1),
            base_lag + num_valid[0],
            _pack(CafPeak(*(x[0] for x in chunk_lat))))


def _stein_lattice_rescore(needle, bws, offs, freqs_t, sample_rate: float,
                           xl: int, max_lag: int, win: int) -> CafPeak:
    """Exact filterbank re-score of each carried window: (P,) fields.

    The argmax is constrained twice:

    * to window lags ``[0, max_lag]``, the full-overlap neighbourhood —
      an unconstrained argmax over the window's circular xcor can land on
      a partial or wrapped alignment against another emitter in the
      slice, at a lag the post-re-score NMS cannot dedup;
    * to within ``win`` (one resolution cell) of entry ``i``'s own
      carried candidate ``offs[i]`` — a stronger same-bin emitter inside
      the slice would otherwise take the argmax and collapse the entry
      onto itself.
    """
    surf = mag2(_surface_rows(needle, bws, freqs_t, sample_rate, xl))
    cols = torch.arange(xl, dtype=torch.int32, device=surf.device)
    keep = (cols <= max_lag) & ((cols - offs[:, None]).abs() <= win)
    return find_peak_2d(torch.where(keep[:, None, :], surf, -math.inf))


def _energy(chunk, device: torch.device):
    """Σ|h|² of a chunk as the JAX package sums it: each float plane's
    squares summed in the plane's dtype.  A tensor on ``device`` gives a
    0-d f64 tensor there (nothing read back); a host chunk a float."""
    if isinstance(chunk, torch.Tensor):
        e = chunk.real.square().sum() + chunk.imag.square().sum()
        return e.double() if chunk.device == device else float(e.item())
    return float(np.sum(chunk.real ** 2) + np.sum(chunk.imag ** 2))


def _upload(chunk, device: torch.device) -> torch.Tensor:
    """A chunk as a complex tensor on ``device``; one from the host goes
    up without waiting for the card."""
    x = as_signal(chunk, chunk.device if isinstance(chunk, torch.Tensor)
                  else "cpu")
    return x.to(device, non_blocking=x.device.type == "cpu")


class StreamingCAF:
    """Stateful chunk-at-a-time CAF over one (needle, capture) pair.

    >>> s = StreamingCAF(needle, freqs_hz, sample_rate)
    >>> for chunk in capture_chunks:          # c64 chunks, any lengths
    ...     chunk_peak = s.process(chunk)     # this chunk's local peak
    >>> freq, lag, value = s.best()           # global running peak

    ``backend='stein'`` runs K1, the fused Stein rank, once a chunk in
    place of K inverse FFTs; per-chunk local peaks report the coarse
    (bin-ranked) frequency and value, and :meth:`best` re-scores the
    carried best window exactly.  Every other backend name runs cuFFT
    steps (``torch.fft``).  ``device`` as everywhere in the port: the
    CUDA card unless ``"cpu"`` is asked for.

    With ``backend='stein'`` and ``num_peaks > 1``, K1 carries two lag
    candidates a doppler bin and chunk window, exact for same-bin pairs
    more than ``exclude_lag`` apart (the JAX package's kernel: more than
    ``2*exclude_lag``); three or more same-bin emitters in one window
    exceed the two slots, which the cuFFT stream's lattice does not.

    The stream does not band its grid, so its one K1 program holds 2B =
    2*N_pad/D rows: a 4096-sample needle on a +-1000 Hz grid at 48 kHz
    gives D = 8 and 2B = 1024, which K1 shares over a cluster of 2
    blocks a lag tile.  Past K1's ceiling (9984 rows at D <= 128) a Stein
    stream raises ``VmemBudgetError`` here, at construction.

    On a card each step, the needle's spectra and the exact re-score are
    compiled calls (``ops/_graph``): one CUDA graph per static key, so a
    stream's chunks, a short last one padded to the pinned length among
    them, replay one graph.  A chunk reads back only its packed peak.
    Lags are int32, as in the JAX package: past 2**31 - 1 a step raises
    ``OverflowError``.
    """

    def __init__(self, needle, freqs_hz, sample_rate, *,
                 chunk_len: Optional[int] = None,
                 backend: Optional[str] = None,
                 num_peaks: int = 1,
                 exclude_freq: Optional[int] = None,
                 exclude_lag: Optional[int] = None,
                 device=None):
        with span("caf.stream.build"):
            with span("caf.prep"):
                n, d = self._plan(needle, freqs_hz, sample_rate, chunk_len,
                                  backend, num_peaks, exclude_freq,
                                  exclude_lag, device)
            with span("caf.stream.operator"):
                self._build(n, d)

    def _plan(self, needle, freqs_hz, sample_rate, chunk_len, backend,
              num_peaks, exclude_freq, exclude_lag, device):
        """The build's host part: checks, the grid, the exclusions and
        the host state.  Returns the needle on the device and the Stein
        block length (None for cuFFT steps)."""
        backend = resolve_backend(backend)
        self._stein = backend.startswith("stein")
        self._num_peaks = int(num_peaks)
        # Engine-level names: the stream's transforms run on torch.fft;
        # 'stein*' selects the K1 steps.
        self.backend = ("xla" if backend.startswith(("stein", "pallas"))
                        else backend)
        n = as_signal(needle, device)
        self.device = n.device
        self.needle_len = int(n.shape[-1])
        self.sample_rate = float(sample_rate)
        rdtype = np.float64 if n.dtype == torch.complex128 else np.float32
        self._freqs = as_grid(freqs_hz, dtype=rdtype)
        self._freqs_t = _as_tensor(self._freqs, self.device)
        n_host = n.cpu().numpy()
        # Resolution once, after input validation, and only where used.
        if self._stein or (self._num_peaks > 1 and
                           (exclude_freq is None or exclude_lag is None)):
            auto = resolve_exclusions(n_host, self._freqs, sample_rate,
                                      None, None)
        if self._num_peaks > 1:
            self._exclude = (
                auto[0] if exclude_freq is None else int(exclude_freq),
                auto[1] if exclude_lag is None else int(exclude_lag))
        d = None
        if self._stein:
            # The exact re-score's slack around each carried candidate
            # is resolution-derived (at least 4 samples, for bf16
            # flat-top ties), whatever the NMS windows.
            self._rescore_win = max(auto[1], 4)
            d = _pow2_block_len(self.sample_rate, self._freqs, 64)
        self._needle_energy = _energy(n_host, None)
        self._cdtype, self._np_cdtype = n.dtype, n_host.dtype
        self._samples_seen = 0
        # The chunk length is pinned here or by the first chunk: shorter
        # chunks are zero-padded with their surplus lags masked, longer
        # ones split.
        self._chunk_len = int(chunk_len) if chunk_len else None
        # Lag t needs samples [t, t + N); the first tail is synthetic
        # zeros, so window lags start at -(N-1).  The steps carry it on
        # the device; the host copy checks int32's range.
        self._base_lag = -(self.needle_len - 1)
        return n, d

    def _build(self, n: torch.Tensor, d: Optional[int]) -> None:
        """The build's device part: the needle's operator and weights
        (Stein) or spectra (cuFFT), and the state tensors."""
        p = self._num_peaks
        slots = (p,) if p > 1 else ()
        if self._stein:
            n_pad = pad_to(n, self.needle_len + (-self.needle_len) % SUPER)
            self._needle_pad = int(n_pad.shape[-1])
            self._n_padded = n_pad
            self._num_blocks = self._needle_pad // d
            self._lmat, self._group = _needle_operator(
                n_pad.real[None], n_pad.imag[None], d)
            check_kernel_shape(self._lmat.shape[1], self._group)
            self._ws = stein_synthesis_weights(self._freqs_t,
                                               self.sample_rate,
                                               self._num_blocks, d)
            self._carry = self._needle_pad + _RESCORE_PAD
            self._bw = n.new_zeros(slots + (self._carry,))
            self._bw_start = torch.zeros(slots, dtype=torch.int32,
                                         device=self.device)
        else:
            self._s_conj = _graph.compiled(
                needle_spectra_conj, (n, self._freqs_t),
                (self.sample_rate, xcor_length(self.needle_len)))
        self._num_valid = {}      # valid length -> its (1,) int32 tensor
        self._tail = n.new_zeros(self.needle_len - 1)
        # Floor state: measured (sum, count) accumulators for the cuFFT
        # steps; sample-energy sums for the Stein steps' model floor (K1
        # reduces each bin to its (max, argmax): no cells to average),
        # an f64 sum of each chunk's plane sums, as a Python float adds.
        self._fsum = torch.zeros((), dtype=n.real.dtype, device=self.device)
        self._fcnt = torch.zeros_like(self._fsum)
        self._h2_sum = torch.zeros((), dtype=torch.float64,
                                   device=self.device)
        self._best = CafPeak(
            torch.full(slots, -math.inf, dtype=n.real.dtype,
                       device=self.device),
            torch.zeros(slots, dtype=torch.int32, device=self.device),
            torch.zeros(slots, dtype=torch.int32, device=self.device))
        self._base = torch.full((), self._base_lag, dtype=torch.int32,
                                device=self.device)

    @property
    def samples_seen(self) -> int:
        return self._samples_seen

    def noise_floor(self) -> float:
        """Mean mag^2 per surface cell over everything seen so far.

        cuFFT steps: measured — each window's scan accumulates (sum,
        count) over its valid cells.  Stein steps: the exponential-cell
        model ``Σ|n|² · mean|h|²`` (a noise-only xcor cell is a
        complex-Gaussian sum with that second moment).  0.0 before any
        chunk."""
        if self._stein:
            if self._samples_seen == 0:
                return 0.0
            return (self._needle_energy * float(self._h2_sum)
                    / self._samples_seen)
        fsum, cnt = torch.stack([self._fsum, self._fcnt]).tolist()
        return fsum / cnt if cnt > 0 else 0.0

    def searched_cells(self) -> int:
        """(doppler, lag) cells searched so far: the ``n`` of
        :func:`caf_cookoff_tpu_torch.ops.peak.detection_threshold_db`."""
        return int(self._samples_seen) * int(len(self._freqs))

    def process(self, chunk) -> Tuple[float, int, float]:
        """Consume one chunk; returns this chunk's (freq, lag, value).

        Lags are absolute sample indices into the capture (negative for
        alignments that start before it); a chunk's window also covers
        correlations that straddle the previous chunk boundary.  Any
        chunk length is accepted: short chunks are zero-padded to the
        pinned length and their surplus lags masked, oversized ones run
        in slices (the reported peak is the best slice's).  One small
        tensor comes back to the host a chunk."""
        if not recording():
            return self._process(chunk, False)
        with span("caf.stream.chunk"):
            return self._process(chunk, True)

    def _process(self, chunk, spans: bool) -> Tuple[float, int, float]:
        if not isinstance(chunk, torch.Tensor):
            chunk = np.asarray(chunk)
        if chunk.ndim == 0 or chunk.shape[-1] == 0:
            raise ValueError("empty signal (zero-length last axis)")
        if not isinstance(chunk, torch.Tensor):
            chunk = chunk.astype(self._np_cdtype, copy=False)
        valid = int(chunk.shape[-1])
        if self._chunk_len is None:
            self._chunk_len = valid
        fixed = self._chunk_len
        if valid <= fixed:
            return self._step(chunk, spans)
        best = None
        for off in range(0, valid, fixed):
            local = self._step(chunk[off:off + fixed], spans)
            if best is None or local[2] > best[2]:
                best = local
        return best

    def _step(self, chunk, spans: bool) -> Tuple[float, int, float]:
        """One step: the chunk staged on the device, the compiled step,
        its peak read back; the first and last in their spans when
        ``spans``."""
        valid = int(chunk.shape[-1])
        if self._base_lag > _INT32_MAX:
            raise OverflowError(
                f"window base lag {self._base_lag} past int32: a stream's "
                f"lags are int32, as in the JAX package")
        if not spans:
            value, f, lag = self._advance(*self._stage(chunk, valid),
                                          valid).tolist()
        else:
            with span("caf.stream.upload"):
                staged = self._stage(chunk, valid)
            local = self._advance(*staged, valid)
            with span("caf.read"):
                value, f, lag = local.tolist()
        return float(self._freqs[int(f)]), int(lag), value

    def _stage(self, chunk, valid: int):
        """The chunk padded to the pinned length on the device, and its
        valid length as a (1,) int32 tensor there."""
        if self._stein:
            # Model-floor input from the valid samples, before padding.
            self._h2_sum = self._h2_sum + _energy(chunk, self.device)
        ch = pad_to(_upload(chunk, self.device).to(self._cdtype),
                    self._chunk_len)
        nv = self._num_valid.get(valid)
        if nv is None:
            nv = self._num_valid[valid] = torch.full(
                (1,), valid, dtype=torch.int32, device=self.device)
        return ch, nv

    def _advance(self, ch, nv, valid: int) -> torch.Tensor:
        """The compiled step on a staged chunk: the state moves on and
        the chunk's peak comes back packed, on the device."""
        lattice = ((self._num_peaks, *self._exclude)
                   if self._num_peaks > 1 else ())
        if self._stein:
            core = (_stein_stream_lattice_step if lattice
                    else _stein_stream_step)
            traced = (*self._ws, self._lmat, self._tail, ch, *self._best,
                      self._bw, self._bw_start, self._base, nv)
            static = (self._num_blocks, self._group, self.needle_len,
                      self._carry, *lattice)
        else:
            core = _stream_lattice_step if lattice else _stream_step
            traced = (self._s_conj, self._tail, ch, *self._best, self._fsum,
                      self._fcnt, self._base, nv)
            static = (self.needle_len, *lattice)
        *best, c0, c1, self._tail, self._base, local = _graph.compiled(
            core, traced, static)
        self._best = CafPeak(*best)
        if self._stein:
            self._bw, self._bw_start = c0, c1
        else:
            self._fsum, self._fcnt = c0, c1
        self._samples_seen += valid
        self._base_lag += valid
        return local

    def _rescore(self, bws, offs) -> CafPeak:
        """:func:`_stein_lattice_rescore` as a compiled call (JAX's
        ``_stein_lattice_rescore_jit``; ``xl``, ``max_lag`` and ``win``
        static)."""
        return CafPeak(*_graph.compiled(
            _stein_lattice_rescore,
            (self._n_padded, bws, offs, self._freqs_t),
            (self.sample_rate, xcor_length(self._needle_pad),
             self._needle_pad + _RESCORE_PAD - self.needle_len,
             self._rescore_win)))

    def best(self) -> Tuple[float, int, float]:
        """Global running (freq_hz, lag, value) over everything seen.

        Stein steps only ranked bins: the carried best window is
        re-scored here with exact filterbank rows (the rank-then-score
        contract), which restores the bin-exact frequency and lag."""
        with span("caf.stream.best"):
            return self._best_now()

    def _best_now(self) -> Tuple[float, int, float]:
        if self._num_peaks > 1:
            if self._stein:
                fr, lg, vv = self.peaks()
                return float(fr[0]), int(lg[0]), float(vv[0])
            with span("caf.read"):
                value, f, lag = (torch.stack([x[0].double()
                                              for x in self._best]).tolist())
            return float(self._freqs[int(f)]), int(lag), value
        row = [x.double() for x in self._best]
        if self._stein:
            pk = self._rescore(self._bw[None],
                               (self._best.lag_idx - self._bw_start)[None])
            row += [pk.value[0].double(), pk.freq_idx[0].double(),
                    (pk.lag_idx[0] + self._bw_start).double()]
        with span("caf.read"):
            row = torch.stack(row).tolist()
        if self._stein and math.isfinite(row[0]):
            row = row[3:]
        value, f, lag = row[:3]
        return float(self._freqs[int(f)]), int(lag), value

    def peaks(self, min_snr_db=None, with_snr: bool = False):
        """Global running top-``num_peaks`` lattice, strongest first.

        Returns ``(freqs_hz (P,), lags (P,), values (P,)[, snr_db])``
        numpy arrays; slots past the distinct detections carry
        ``value=-inf``.  Requires ``num_peaks > 1`` at construction.
        ``min_snr_db`` (float or ``"auto"``) masks slots whose
        peak-to-:meth:`noise_floor` dB falls below it to ``-inf``;
        ``with_snr=True`` appends the per-slot dB.

        Stein steps only ranked: each entry's carried window is re-scored
        here with exact filterbank rows, the lattice re-sorts on the
        exact values and a host NMS drops coarse cells that re-scored
        onto one peak."""
        if self._num_peaks <= 1:
            raise ValueError(
                "stream was built with num_peaks=1; construct "
                "StreamingCAF(..., num_peaks=P) to track a lattice")

        def finish(freqs, lags, values):
            if min_snr_db is None and not with_snr:
                return freqs, lags, values
            vals, snr, _ = apply_detection_threshold(
                values, self.noise_floor(), self.searched_cells(),
                min_snr_db)
            return (freqs, lags, vals) + ((snr,) if with_snr else ())

        if not self._stein:
            return finish(*_host(self._freqs, self._best))
        pk = self._rescore(self._bw, self._best.lag_idx - self._bw_start)
        with span("caf.read"):
            coarse, vals, bins, lags = torch.stack(
                [self._best.value.double(), pk.value.double(),
                 pk.freq_idx.double(),
                 (pk.lag_idx + self._bw_start).double()]).cpu().numpy()
        vals = np.where(np.isfinite(coarse), vals, -np.inf)
        bins, lags = bins.astype(np.int64), lags.astype(np.int64)
        ef, el = self._exclude
        kept = []
        for i in np.argsort(-vals, kind="stable"):
            if np.isfinite(vals[i]) and any(
                    abs(bins[i] - bins[j]) <= ef
                    and abs(lags[i] - lags[j]) <= el for j in kept):
                continue
            kept.append(i)
        out_f = np.full(self._num_peaks, 0.0)
        out_l = np.zeros(self._num_peaks, np.int64)
        out_v = np.full(self._num_peaks, -np.inf)
        for slot, i in enumerate(kept[:self._num_peaks]):
            if not np.isfinite(vals[i]):
                break
            out_f[slot] = self._freqs[bins[i]]
            out_l[slot] = lags[i]
            out_v[slot] = vals[i]
        return finish(out_f, out_l, out_v)
