"""Command-line interface (``generate``, ``run``, ``stream``, ``capture``,
``batch``, ``bench``, ``selftest``, ``info``).

  python -m caf_cookoff_tpu_torch generate --out DIR
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 HAYSTACK.c64 [--backend stein]
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 CAPTURE.c64 --full-haystack
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 CAPTURE.c64 [--full-haystack] --num-peaks 3
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 CAPTURE.c64 [--refine] [--rate]
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 CAPTURE.c64 [--full-haystack] --rate-grid=-300:300:150 [--num-peaks 2]
  python -m caf_cookoff_tpu_torch run NEEDLE.c64 HAYSTACK.c64 [--dump-surface S.npy] [--plot S.png] [--annotate]
  python -m caf_cookoff_tpu_torch stream NEEDLE.c64 CAPTURE.c64 [--chunk 4096] [--backend stein] [--num-peaks 3] [--follow]
  python -m caf_cookoff_tpu_torch capture OUT [--seconds 5] [--device INDEX]
  python -m caf_cookoff_tpu_torch batch N1.c64:C1.c64 N2.c64:C2.c64 [--full-haystack] [--num-peaks 3] [--refine]
  python -m caf_cookoff_tpu_torch bench [--backends xla,pallas-refine,stein]
  python -m caf_cookoff_tpu_torch selftest [--backend pallas-refine]
  python -m caf_cookoff_tpu_torch info

``run`` truncates the haystack to the needle length, as the reference
does, and prints the reference's two result lines, a bracketed line
(the peak over the surface's median; ms a surface and surfaces a
second, from a second call when the first took under 2 s; the backend)
and the engine that answered; ``--dump-surface``, ``--plot`` and
``--annotate`` write the surface, its image and a SigMF annotation;
``--full-haystack`` searches the whole capture (the segmented
long-capture engine, or the overlap-save scan where that engine is
ineligible).  ``--num-peaks N`` also lists the N strongest emitters
(non-maximum suppressed lattices, each slot held to a detection
threshold, ``--min-snr-db``).  ``--refine`` zooms the answer (and each
listed row) to continuous (freq, lag), ``--rate`` adds a doppler rate;
``--rate-grid`` searches trial rates (the rate engines) and refines the
answer in (freq, rate, lag).  ``batch`` runs many pairs through the
batched Stein engines (``--num-peaks``: a lattice per pair; ``--refine``:
one batched zoom).  ``run`` and ``batch`` read raw ``.c64`` or SigMF
recordings (either sidecar; ``run --segment N`` picks one capture
segment); a recording's ``core:sample_rate`` replaces the default
``--fs`` and is warned about when an explicit ``--fs`` disagrees.
``stream`` runs a capture chunk by chunk through ``StreamingCAF``
(``--follow`` tails a growing SigMF recording); ``capture`` records one
from a sound card (the optional ``sounddevice`` package).  Every verb
that computes runs on the CUDA card unless ``--device cpu`` asks for the
CPU; ``bench`` times the card only, and ``capture --device`` is the
sound card's input index (it touches no torch device).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from caf_cookoff_tpu_torch.config import (BACKENDS, BENCH_GRID,
                                          DEFAULT_SAMPLE_RATE, FreqGrid)
from caf_cookoff_tpu_torch.errors import EngineError

_DEVICE_HELP = ("torch device (default: the CUDA card; without one the "
                "command fails unless --device cpu asks for the CPU)")
# run --full-haystack: surfaces up to this many cells are computed whole
# for the artifacts, larger ones as a needle-length window at the peak.
FULL_SURFACE_CELLS = 2 ** 26
_BACKEND_HELP = ("auto/xla/matmul*: filterbank on torch.fft; pallas "
                 "(-refine, -bf16): fused filterbank kernel, every tier "
                 "in f32; stein: segmented engine with the fused rank "
                 "kernel and exact re-score")


def _add_grid_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--freq-start", type=float, default=BENCH_GRID.start_hz,
                   help="doppler grid start (Hz)")
    p.add_argument("--freq-stop", type=float, default=BENCH_GRID.stop_hz,
                   help="doppler grid stop, exclusive (Hz)")
    p.add_argument("--freq-step", type=float, default=BENCH_GRID.step_hz,
                   help="doppler grid step (Hz)")
    p.add_argument("--fs", type=float, default=None,
                   help=f"sample rate (Hz; default {DEFAULT_SAMPLE_RATE:g},"
                   " or the recording's core:sample_rate for SigMF input)")


def _grid(args) -> FreqGrid:
    return FreqGrid(args.freq_start, args.freq_stop, args.freq_step)


def cmd_generate(args) -> int:
    from caf_cookoff_tpu_torch.utils.generate import synthesize_fixtures

    for needle, haystack in synthesize_fixtures(args.out, count=args.count,
                                                seed=args.seed):
        print(f"{needle}  +  {haystack}")
    return 0


def _load_signal(path: str, segment: Optional[int] = None):
    """Raw ``.c64`` samples or a SigMF recording (either sidecar):
    ``(samples, meta_fs)``, ``meta_fs`` the recording's own
    ``core:sample_rate`` (``None`` for ``.c64``, which carries none).
    ``segment`` selects one capture segment of a multi-capture SigMF
    recording (sample indices then count from that segment's start)."""
    from caf_cookoff_tpu_torch.utils.io import load_c64

    if ".sigmf" in path:
        from caf_cookoff_tpu_torch.utils.sigmf import read_sigmf

        rec = read_sigmf(path)
        if segment is not None:
            return rec.segment(segment), (rec.sample_rate or None)
        if len(rec.captures) > 1:
            print(f"note: {path} has {len(rec.captures)} capture "
                  f"segments; processing the whole stream (use "
                  f"--segment N to select one)", file=sys.stderr)
        return rec.samples, (rec.sample_rate or None)
    if segment not in (None, 0):
        raise ValueError("--segment applies only to SigMF recordings")
    return load_c64(path), None


def _effective_fs(args, *meta_rates) -> float:
    """``--fs`` reconciled with the recordings' sample rates: a recorded
    rate overrides the default (with a note) and loses to an explicit
    ``--fs`` it disagrees with (with a warning: the user may be
    relabelling the axis), since a silently wrong fs gives a confidently
    wrong doppler axis."""
    explicit = args.fs is not None
    fs = args.fs if explicit else DEFAULT_SAMPLE_RATE
    rates = {float(r) for r in meta_rates if r}
    if not rates:
        return fs
    if len(rates) > 1:
        print(f"WARNING: needle/haystack recordings disagree on "
              f"core:sample_rate ({sorted(rates)}); using fs={fs:g}",
              file=sys.stderr)
        return fs
    meta = rates.pop()
    if abs(meta - fs) <= 1e-6 * max(meta, fs):
        return fs
    if not explicit:
        print(f"note: using the recording's core:sample_rate "
              f"{meta:g} Hz (no explicit --fs given)", file=sys.stderr)
        return meta
    print(f"WARNING: --fs={fs:g} != recording core:sample_rate "
          f"{meta:g}; doppler estimates use --fs", file=sys.stderr)
    return fs


def _rate_grid(spec: str):
    """``--rate-grid START:STOP:STEP`` -> the trial rates (Hz/s, the stop
    included), or ``None`` when the spec is malformed."""
    try:
        r0s, r1s, rss = spec.split(":")
        return (np.arange(float(r0s), float(r1s) + 1e-9, float(rss)),
                float(rss))
    except ValueError:
        return None


def _parse_min_snr(value):
    """``--min-snr-db``: 'auto' (the cell-count threshold), 'none'/'off'
    (no masking) or a float dB value."""
    if value is None:
        return None
    s = str(value).strip().lower()
    if s in ("none", "off"):
        return None
    if s == "auto":
        return "auto"
    try:
        return float(s)
    except ValueError:
        raise SystemExit(
            f"error: --min-snr-db wants 'auto', 'none', or a float dB "
            f"value, got {value!r}")


def _print_lattice(rows, num_peaks: int, min_snr, min_snr_arg,
                   refine_fn=None, rates=None, what="lattice") -> None:
    """The multi-peak listing: the "Detections: N of M" line when a
    threshold is active, then one row a slot, with below-threshold /
    no-further-peaks tags.  ``rows`` are ``(freq_hz, lag, value,
    snr_db)``, value -inf for empty or masked slots; ``rates`` adds a
    Hz/s column; ``refine_fn(i)`` returns a suffix for finite row ``i``."""
    if min_snr is not None:
        n_det = sum(1 for r in rows if np.isfinite(r[2]))
        print(f"Detections: {n_det} of {num_peaks} {what} "
              f"slots pass the SNR threshold "
              f"(--min-snr-db {min_snr_arg})")
    for i, (f_hz, lag_i, val, snr_db) in enumerate(rows):
        if not np.isfinite(val):
            tag = ("below detection threshold" if np.isfinite(snr_db)
                   else "no further distinct peaks")
            print(f"peak {i + 1}: ({tag})")
            continue
        rate = "" if rates is None else f" {rates[i]:+8.1f} Hz/s"
        line = (f"peak {i + 1}: {f_hz:+9.3f} Hz{rate} "
                f"@ lag {lag_i:>6d}  ({val:.5g}, {snr_db:.1f} dB)")
        print(line + (refine_fn(i) if refine_fn is not None else ""))


def _run_lattice(needle, haystack, freqs, full: bool, surface,
                 args) -> None:
    """``run --num-peaks``: over the whole capture the fused lattice
    engine (the lattice scan when it raises an ``EngineError``), else
    ``find_peaks`` on the truncated pair's circular ``surface``, whose
    floor is the surface mean; lags signed as the result lines'.
    ``--refine`` adds each row's zoom estimate."""
    from caf_cookoff_tpu_torch.config import xcor_length
    from caf_cookoff_tpu_torch.models.batched_stein import (
        batched_stein_os_peaks)
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peaks
    from caf_cookoff_tpu_torch.ops.peak import (apply_detection_threshold,
                                                find_peaks, resolution_cell,
                                                unwrap_lag)

    min_snr = _parse_min_snr(args.min_snr_db)
    # Exclusion windows = the waveform's resolution cell.
    excl = dict(zip(("exclude_freq", "exclude_lag"),
                    resolution_cell(needle, freqs, args.fs)))
    if full:
        try:
            # SNR against the engine's model floor; the scan measures its
            # floor (same dB scale).
            out = batched_stein_os_peaks(
                needle[None], haystack[None], freqs, args.fs, args.num_peaks,
                min_snr_db=min_snr, with_snr=True, device=args.device, **excl)
            fr, lg, vv, snr = (x[0] for x in out)
        except EngineError as exc:
            print(f"note: lattice shape outside the fused engine's "
                  f"envelope ({exc}); using the lattice scan",
                  file=sys.stderr)
            fr, lg, vv, snr = overlap_save_peaks(
                needle, haystack, freqs, args.fs, args.num_peaks,
                min_snr_db=min_snr, with_snr=True, device=args.device,
                **excl)
        rows = list(zip(fr.tolist(), lg.tolist(), vv.tolist(),
                        snr.tolist()))
    else:
        n = len(needle)
        # Circular surface: the lag period keeps a wrap-around skirt
        # from taking a slot.
        pks = find_peaks(surface, args.num_peaks, lag_period=surface.shape[-1],
                         **excl)
        vals, snr, _ = apply_detection_threshold(
            pks.value.cpu().numpy(), float(surface.double().mean()),
            surface.numel(), min_snr)
        rows = [(float(freqs[int(pks.freq_idx[i])]),
                 unwrap_lag(int(pks.lag_idx[i]), xcor_length(n), n),
                 float(vals[i]), float(snr[i]))
                for i in range(args.num_peaks)]
    refine_fn = None
    if args.refine:
        from caf_cookoff_tpu_torch.ops.refine import refine_peak

        def refine_fn(i):
            f_ref, t_ref, _ = refine_peak(
                needle, haystack, rows[i][0], rows[i][1], args.fs,
                coarse_step_hz=args.freq_step, device=args.device)
            return f"  refined {f_ref:+9.4f} Hz @ {t_ref:.4f}"
    _print_lattice(rows, args.num_peaks, min_snr, args.min_snr_db, refine_fn)


def cmd_run(args) -> int:
    from caf_cookoff_tpu_torch.config import resolve_backend, xcor_length
    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.ops.peak import unwrap_lag
    from caf_cookoff_tpu_torch.ops.refine import refine_peak, refine_peak_rate
    from caf_cookoff_tpu_torch.utils.profiling import (RunReport, Stopwatch,
                                                       peak_to_floor_db)

    rate_grid = None
    if args.rate_grid:
        rate_grid = _rate_grid(args.rate_grid)
        if rate_grid is None:
            print(f"error: --rate-grid wants START:STOP:STEP, got "
                  f"{args.rate_grid!r}", file=sys.stderr)
            return 2
    backend = resolve_backend(args.backend)
    needle, n_fs = _load_signal(args.needle)
    haystack, h_fs = _load_signal(args.haystack, segment=args.segment)
    args.fs = _effective_fs(args, n_fs, h_fs)
    n = len(needle)
    freqs = _grid(args).frequencies(np.float32)
    full = args.full_haystack and len(haystack) > n
    # The engine that answered, and the scan's SNR where one ran.
    state = {"engine": f"filterbank[{backend}]", "snr_db": None,
             "noted": False}

    def solve():
        if full:
            out = _full_haystack_peak(needle, haystack, freqs, args,
                                      quiet=state["noted"])
            state["noted"] = True
            state["engine"], state["snr_db"] = out[3:]
            return out[:3]
        return caf_peak(needle, haystack[:n], freqs, args.fs,
                        backend=args.backend, device=args.device)

    with Stopwatch() as sw0:
        freq, lag, value = solve()      # the first call pays the build
    elapsed_ms = None
    if sw0.ms < 2_000.0:
        # A second call times the steady state; a multi-second search is
        # not worth doubling for it.
        with Stopwatch() as sw:
            solve()
        elapsed_ms = sw.ms
    surface, lag_origin = _run_surface(needle, haystack, freqs, full, lag,
                                       backend, args)
    surface_np = None if surface is None else surface.cpu().numpy()
    report = RunReport(
        freq_hz=freq, lag_samples=lag, peak_value=value, sample_rate=args.fs,
        num_doppler_bins=len(freqs), xcor_len=xcor_length(n),
        elapsed_ms=elapsed_ms,
        peak_to_floor_db=(peak_to_floor_db(surface_np, value)
                          if surface_np is not None else state["snr_db"]),
        backend=backend)
    print(report.result_lines())
    print(f"Peak value: {value:.6g}")
    print(f"Engine: {state['engine']}")
    if lag_origin:
        print(f"note: surface-derived outputs cover a {n}-sample window "
              f"at lag {lag_origin} (capture too large for the full "
              f"surface)", file=sys.stderr)
    if args.annotate and ".sigmf" in args.haystack:
        from caf_cookoff_tpu_torch.utils.sigmf import (annotate_detection,
                                                       caf_annotation)

        # With --segment the lag is segment-relative; annotate_detection
        # rebases it to that capture's absolute index.
        annotate_detection(args.haystack, caf_annotation(
            lag, n, freq, value, needle_id=args.needle),
            segment=args.segment)
        print(f"annotation -> {args.haystack}"
              + (f" (segment {args.segment})"
                 if args.segment is not None else ""))
    # The refiners take signed capture offsets: the truncated path's raw
    # circular xcor index unwraps first.  They read the whole capture.
    signed = lag if full else unwrap_lag(lag, xcor_length(n), n)
    if args.refine:
        f_ref, t_ref, _ = refine_peak(needle, haystack, freq, signed,
                                      args.fs, coarse_step_hz=args.freq_step,
                                      device=args.device)
        print(f"Refined estimate: {f_ref:+.4f} Hz, {t_ref:.4f} "
              f"samples ({t_ref / args.fs * 1e3:.6f} ms)")
    rate_lattice = False
    if rate_grid is not None:
        rate_lattice = full and args.num_peaks > 1
        _run_rate_grid(needle, haystack, freqs, full, *rate_grid, args)
    elif args.rate:
        f2, r2, t2, _ = refine_peak_rate(needle, haystack, freq, signed,
                                         args.fs,
                                         coarse_step_hz=args.freq_step,
                                         device=args.device)
        print(f"Second-order estimate: {f2:+.4f} Hz {r2:+.3f} Hz/s @ "
              f"{t2:.4f} samples")
    if args.num_peaks > 1 and not rate_lattice:
        _run_lattice(needle, haystack, freqs, full, surface, args)
    if args.dump_surface:
        from caf_cookoff_tpu_torch.utils.io import dump_surf, save_npy

        if args.dump_surface.endswith(".npy"):
            save_npy(args.dump_surface, surface_np)
        else:
            # The Go reference's raw little-endian f64 rows.
            dump_surf(args.dump_surface, surface_np.astype(np.float64))
        origin = f", lag axis offset +{lag_origin}" if lag_origin else ""
        print(f"surface ({surface_np.shape[0]}x{surface_np.shape[1]}) -> "
              f"{args.dump_surface}{origin}")
    if args.plot:
        _plot_surface(surface_np, freqs, args.plot, lag_origin=lag_origin)
    return 0


def _run_surface(needle, haystack, freqs, full: bool, lag: int, backend,
                 args):
    """The surface behind ``run``'s peak/floor and artifacts, as a tensor,
    and its lag origin.  Truncated pairs: the pair's surface, always.
    ``--full-haystack``, only when an artifact needs one (the lattice
    scans the capture itself): the whole overlap-save surface when
    ``K x lags <= FULL_SURFACE_CELLS``, else the needle-length window
    around the found lag, whose lags start at ``lag_origin`` — never the
    truncated prefix, which could contradict the reported peak."""
    from caf_cookoff_tpu_torch.models.filterbank import caf_surface
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_surface

    n = len(needle)
    if not full:
        return caf_surface(needle, haystack[:n], freqs, args.fs,
                           backend=backend, device=args.device), 0
    if not (args.dump_surface or args.plot):
        return None, 0
    if len(freqs) * (len(haystack) - n + 1) <= FULL_SURFACE_CELLS:
        return overlap_save_surface(needle, haystack, freqs, args.fs,
                                    device=args.device), 0
    origin = max(0, min(lag - 64, len(haystack) - n))
    return caf_surface(needle, haystack[origin:origin + n], freqs, args.fs,
                       backend=backend, device=args.device), origin


def _plot_surface(surface: np.ndarray, freqs: np.ndarray, out_path: str,
                  lag_origin: int = 0) -> None:
    """imshow of the delay-doppler surface (matplotlib, Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kmax, tmax = np.unravel_index(surface.argmax(), surface.shape)
    fig, ax = plt.subplots(figsize=(8, 6))
    extent = (lag_origin, lag_origin + surface.shape[1],
              float(freqs[-1]), float(freqs[0]))
    ax.imshow(10 * np.log10(surface + 1e-20), aspect="auto", extent=extent,
              cmap="viridis")
    ax.plot(lag_origin + tmax + 0.5, freqs[kmax], "rx", markersize=12)
    ax.set_xlabel("lag (samples)")
    ax.set_ylabel("doppler (Hz)")
    ax.set_title(f"CAF surface — peak {freqs[kmax]:+.2f} Hz @ "
                 f"{lag_origin + tmax} samp")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"plot -> {out_path}")


def _run_rate_grid(needle, haystack, freqs, full: bool, rates, rate_step,
                   args) -> None:
    """``run --rate-grid``: over the whole capture the segmented rate
    engine (the serial scan when it raises an ``EngineError``), with
    ``--num-peaks`` its lattice in place of the first-order one (each
    row refined by ``refine_peak_rate`` under ``--refine``); on the
    truncated pair the dechirp bank.  A single answer is then refined
    by ``refine_peak_rate``, bracketed at one rate step."""
    from caf_cookoff_tpu_torch.config import xcor_length
    from caf_cookoff_tpu_torch.models import rate as rt
    from caf_cookoff_tpu_torch.ops.peak import unwrap_lag
    from caf_cookoff_tpu_torch.ops.refine import refine_peak_rate

    fs, dev = args.fs, args.device
    note = ("note: rate grid outside the segmented envelope ({}); using "
            "the serial scan")

    def refined(f_hz, lag, rate):
        return refine_peak_rate(needle, haystack, f_hz, lag, fs,
                                rate0_hz_per_s=rate,
                                max_rate_hz_per_s=rate_step,
                                coarse_step_hz=args.freq_step, device=dev)

    if full and args.num_peaks > 1:
        min_snr = _parse_min_snr(args.min_snr_db)
        kw = dict(min_snr_db=min_snr, with_snr=True, device=dev)
        try:
            rr, fr, lg, vv, snr = rt.stein_rate_os_peaks(
                needle, haystack, freqs, rates, fs, args.num_peaks, **kw)
        except EngineError as exc:
            print(note.format(exc), file=sys.stderr)
            rr, fr, lg, vv, snr = rt.rate_overlap_save_peaks(
                needle, haystack, freqs, rates, fs, args.num_peaks, **kw)

        def suffix(i):
            f2, r2, t2, _ = refined(float(fr[i]), int(lg[i]), float(rr[i]))
            return f"  refined {f2:+9.4f} Hz {r2:+8.3f} Hz/s @ {t2:.4f}"

        _print_lattice([(float(f), int(l), float(v), float(s))
                        for f, l, v, s in zip(fr, lg, vv, snr)],
                       args.num_peaks, min_snr, args.min_snr_db,
                       suffix if args.refine else None, rates=rr,
                       what="rate-lattice")
        return
    if full:
        try:
            r_c, f_c, lag_c, v_c = rt.stein_rate_os_peak(
                needle, haystack, freqs, rates, fs, device=dev)
        except EngineError as exc:
            print(note.format(exc), file=sys.stderr)
            r_c, f_c, lag_c, v_c = rt.rate_overlap_save_peak(
                needle, haystack, freqs, rates, fs, device=dev)
    else:
        n = len(needle)
        r_c, f_c, lag_c, v_c = rt.rate_caf_peak(needle, haystack[:n], freqs,
                                                rates, fs, device=dev)
        lag_c = unwrap_lag(lag_c, xcor_length(n), n)
    print(f"Rate-bank peak: {f_c:+.3f} Hz {r_c:+.1f} Hz/s "
          f"@ lag {lag_c} ({v_c:.5g})")
    f2, r2, t2, _ = refined(f_c, lag_c, r_c)
    print(f"Second-order estimate: {f2:+.4f} Hz {r2:+.3f} Hz/s @ {t2:.4f} "
          f"samples")


def _full_haystack_peak(needle, haystack, freqs, args, quiet=False):
    """The whole capture, as the JAX CLI searches it: the segmented
    long-capture engine for ``auto``/``stein*``, the overlap-save scan
    (with its peak-to-floor SNR) otherwise or when that engine raises an
    ``EngineError`` (noted once, unless ``quiet``).  Returns ``(freq,
    lag, value, engine, snr_db)``."""
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peak
    from caf_cookoff_tpu_torch.models.stein import stein_overlap_save_peak

    if args.backend == "auto" or args.backend.startswith("stein"):
        try:
            out = stein_overlap_save_peak(
                needle, haystack, freqs, args.fs,
                refine=not args.backend.endswith("raw"), device=args.device)
            return out + ("stein-os (segmented long-capture)", None)
        except EngineError as exc:
            # Only the typed envelope conditions reroute.
            if not quiet:
                print(f"note: segmented engine ineligible ({exc}); using "
                      f"the overlap-save scan", file=sys.stderr)
    freq, lag, value, snr_db = overlap_save_peak(
        needle, haystack, freqs, args.fs, with_snr=True, device=args.device)
    return freq, lag, value, "overlap-save scan", snr_db


def cmd_stream(args) -> int:
    """A capture chunk by chunk through ``StreamingCAF``; ``--follow``
    tails a growing SigMF recording."""
    from caf_cookoff_tpu_torch.config import resolve_backend
    from caf_cookoff_tpu_torch.models.streaming import StreamingCAF
    from caf_cookoff_tpu_torch.ops.refine import refine_peak

    backend = resolve_backend(args.backend)
    needle, n_fs = _load_signal(args.needle)
    if args.follow:
        from caf_cookoff_tpu_torch.utils.sigmf import _base, follow_sigmf

        # Only the small .sigmf-meta is read here: the data file, which
        # may still be growing, streams chunk by chunk below.
        with open(_base(args.capture) + ".sigmf-meta") as f:
            c_fs = json.load(f).get("global", {}).get(
                "core:sample_rate") or None
        chunks = follow_sigmf(args.capture, chunk=args.chunk,
                              idle_timeout_s=args.idle_timeout)
    else:
        capture, c_fs = _load_signal(args.capture, segment=args.segment)
        chunks = (capture[s:s + args.chunk]
                  for s in range(0, len(capture), args.chunk))
    args.fs = _effective_fs(args, n_fs, c_fs)
    freqs = _grid(args).frequencies(np.float32)
    engine = StreamingCAF(needle, freqs, args.fs, chunk_len=args.chunk,
                          backend=backend, num_peaks=args.num_peaks,
                          device=args.device)
    t0 = time.perf_counter()
    start = 0
    for chunk in chunks:
        freq, lag, value = engine.process(chunk)
        if args.verbose:
            print(f"chunk @{start:>10d}: local peak {freq:+8.2f} Hz "
                  f"@ lag {lag:>8d}  ({value:.4g})")
        start += len(chunk)
    elapsed = time.perf_counter() - t0
    freq, lag, value = engine.best()
    print(f"Frequency offset: {freq:.3f} Hz")
    print(f"Time offset: {lag} samples ({lag / args.fs * 1e3:.4f} ms)")
    print(f"Peak value: {value:.6g}")
    # The refiners read the capture around each lag, which --follow does
    # not keep.
    refine = args.refine and not args.follow
    if args.refine and args.follow:
        print("note: --refine needs the capture bytes around each lag; "
              "--follow discards consumed chunks, so refine is skipped",
              file=sys.stderr)
    if refine:
        f_ref, t_ref, _ = refine_peak(needle, capture, freq, lag, args.fs,
                                      coarse_step_hz=args.freq_step,
                                      device=args.device)
        print(f"Refined estimate: {f_ref:+.4f} Hz, {t_ref:.4f} samples "
              f"({t_ref / args.fs * 1e3:.6f} ms)")
    if args.num_peaks > 1:
        min_snr = _parse_min_snr(args.min_snr_db)
        fr, lg, vv, snr = engine.peaks(min_snr_db=min_snr, with_snr=True)
        rows = [(float(fr[i]), int(lg[i]), float(vv[i]), float(snr[i]))
                for i in range(args.num_peaks)]

        def refine_fn(i):
            f_ref, t_ref, _ = refine_peak(
                needle, capture, rows[i][0], rows[i][1], args.fs,
                coarse_step_hz=args.freq_step, device=args.device)
            return f"  refined {f_ref:+9.4f} Hz @ {t_ref:.4f}"

        _print_lattice(rows, args.num_peaks, min_snr, args.min_snr_db,
                       refine_fn if refine else None)
    print(f"[{engine.samples_seen} samples "
          f"({engine.samples_seen / args.fs * 1e3:.0f} ms of capture) in "
          f"{elapsed:.2f} s, chunk={args.chunk}, {backend}]")
    return 0


def cmd_capture(args) -> int:
    """Record a live audio-band capture to SigMF (needs the optional
    ``sounddevice`` package; ``--device`` is its input index)."""
    from caf_cookoff_tpu_torch.utils.sigmf import record_capture

    try:
        data, meta = record_capture(args.out, args.fs or DEFAULT_SAMPLE_RATE,
                                    seconds=args.seconds, device=args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"capture -> {data} + {meta}")
    return 0


def cmd_batch(args) -> int:
    """Many (needle, capture) pairs through the batched Stein engines:
    equal-length pairs (captures cut to the needle length) or, with
    ``--full-haystack``, whole captures through the windowed engine.  A
    batch outside the engines' envelope (an ``EngineError``) falls back
    to per-pair runs."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        batched_stein_os_peak, batched_stein_peak)
    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.models.overlap_save import overlap_save_peak

    parsed = []
    for spec in args.pairs:
        if ":" not in spec:
            print(f"error: pair {spec!r} is not needle:capture",
                  file=sys.stderr)
            return 2
        parsed.append(spec.split(":", 1))
    needles, captures, rates = [], [], []
    for n_path, c_path in parsed:
        nd, n_fs = _load_signal(n_path)
        cp, c_fs = _load_signal(c_path)
        needles.append(nd)
        captures.append(cp)
        rates.extend([n_fs, c_fs])
    args.fs = _effective_fs(args, *rates)
    n_lens = {len(nd) for nd in needles}
    if len(n_lens) != 1:
        print(f"error: needles must share one length, got {n_lens}",
              file=sys.stderr)
        return 2
    n = n_lens.pop()
    if any(len(c) < n for c in captures):
        print("error: capture shorter than needle", file=sys.stderr)
        return 2
    fs = args.fs
    freqs = _grid(args).frequencies(np.float32)
    cap_lens = [len(c) for c in captures]     # before any padding
    longest = max(len(c) for c in captures)
    full = args.full_haystack and longest > n
    # --refine reads past any truncation: the whole captures, zero-padded
    # to one length.
    captures_full = np.stack([np.pad(c, (0, longest - len(c)))
                              for c in captures])
    if full:
        if any(len(c) <= n for c in captures):
            print("error: --full-haystack needs every capture longer than "
                  "the needle", file=sys.stderr)
            return 2
        captures = [np.pad(c, (0, longest - len(c))) for c in captures]
    else:
        captures = [c[:n] for c in captures]
    try:
        engine = batched_stein_os_peak if full else batched_stein_peak
        fr, lg, vv = engine(np.stack(needles), np.stack(captures), freqs, fs,
                            device=args.device)
    except EngineError as exc:
        # Shapes outside the fused engine's envelope (very wide spans,
        # tiny needles): per-pair engines.  Only the typed envelope
        # conditions reroute.
        print(f"note: batch shape outside the fused engine's envelope "
              f"({exc}); falling back to per-pair runs", file=sys.stderr)
        if full:
            results = [overlap_save_peak(nd, cp, freqs, fs,
                                         device=args.device)
                       for nd, cp in zip(needles, captures)]
        else:
            results = [caf_peak(nd, cp, freqs, fs, backend=args.backend,
                                device=args.device)
                       for nd, cp in zip(needles, captures)]
        fr, lg, vv = (np.array(col) for col in zip(*results))
    records = [{"needle": n_path, "capture": c_path,
                "freq_hz": float(fr[i]), "lag_samples": int(lg[i]),
                "lag_ms": int(lg[i]) / fs * 1e3,
                "peak_value": float(vv[i])}
               for i, (n_path, c_path) in enumerate(parsed)]
    if args.refine:
        _batch_refine(records, np.stack(needles), captures_full, fr, lg,
                      full, args)
    if args.num_peaks > 1:
        lattices = _batch_lattices(np.stack(needles), np.stack(captures),
                                   cap_lens, freqs, full, args)
        for rec, lattice in zip(records, lattices):
            rec["peaks"] = [{"freq_hz": f, "lag_samples": lag,
                             "peak_value": v} for f, lag, v in lattice]
    if args.json:
        print(json.dumps(records, indent=2))
        return 0
    for r in records:
        line = (f"{r['needle']} x {r['capture']}: "
                f"{r['freq_hz']:+9.3f} Hz @ lag {r['lag_samples']:>7d} "
                f"({r['lag_ms']:.4f} ms)  peak {r['peak_value']:.5g}")
        if args.refine:
            line += (f"  refined {r['refined_freq_hz']:+9.4f} Hz @ "
                     f"{r['refined_lag_samples']:.4f}")
        print(line)
        for p, peak in enumerate(r.get("peaks", ())):
            print(f"    peak {p + 1}: {peak['freq_hz']:+9.3f} Hz @ lag "
                  f"{peak['lag_samples']:>7d}  ({peak['peak_value']:.5g})")
    return 0


def _batch_refine(records, needles, captures_full, fr, lg, full: bool,
                  args) -> None:
    """``batch --refine``: one batched zoom over every pair's answer
    against the whole captures (truncated-pair circular lags unwrapped
    first); adds ``refined_freq_hz`` / ``refined_lag_samples`` to each
    record."""
    from caf_cookoff_tpu_torch.config import xcor_length
    from caf_cookoff_tpu_torch.ops.peak import unwrap_lag
    from caf_cookoff_tpu_torch.ops.refine import refine_peaks

    n = needles.shape[-1]
    lags = np.array([int(v) if full else unwrap_lag(v, xcor_length(n), n)
                     for v in lg], np.int64)
    f_ref, t_ref, _ = refine_peaks(needles, captures_full, fr, lags, args.fs,
                                   coarse_step_hz=args.freq_step,
                                   device=args.device)
    for rec, f, t in zip(records, f_ref, t_ref):
        rec["refined_freq_hz"] = float(f)
        rec["refined_lag_samples"] = float(t)


def _batch_lattices(needles, captures, cap_lens, freqs, full: bool, args):
    """``batch --num-peaks``: per pair, the detected lattice rows
    ``(freq_hz, lag, value)``.  Whole captures go through the fused
    long-capture lattice (the batched lattice scan on an
    ``EngineError``), equal-length pairs through the fused batch lattice
    (per-pair surfaces and ``find_peaks`` on an ``EngineError``)."""
    from caf_cookoff_tpu_torch.models.batched_stein import (
        batched_stein_os_peaks, batched_stein_peaks)
    from caf_cookoff_tpu_torch.models.filterbank import caf_surface
    from caf_cookoff_tpu_torch.models.overlap_save import (
        batched_overlap_save_peaks_local)
    from caf_cookoff_tpu_torch.ops.peak import (apply_detection_threshold,
                                                find_peaks, resolution_cell)

    fs = args.fs
    min_snr = _parse_min_snr(args.min_snr_db)
    kw = dict(zip(("exclude_freq", "exclude_lag"),
                  resolution_cell(needles[0], freqs, fs)),
              min_snr_db=min_snr, device=args.device)
    try:
        if full:
            # capture_lens: each pair's real length, so zero padding to
            # one batch length cannot bias the model floor low.
            lf, ll, lv = batched_stein_os_peaks(
                needles, captures, freqs, fs, args.num_peaks,
                capture_lens=cap_lens, **kw)
        else:
            lf, ll, lv = batched_stein_peaks(needles, captures, freqs, fs,
                                             args.num_peaks, **kw)
    except EngineError as exc:
        fallback = "the lattice scan" if full else "per-pair surfaces"
        print(f"note: lattice shape outside the fused engine's envelope "
              f"({exc}); using {fallback}", file=sys.stderr)
        if full:
            lf, ll, lv = batched_overlap_save_peaks_local(
                needles, captures, freqs, fs, args.num_peaks, **kw)
        else:
            rows = []
            for nd, cp in zip(needles, captures):
                surf = caf_surface(nd, cp, freqs, fs, backend=args.backend,
                                   device=args.device)
                pks = find_peaks(surf, args.num_peaks, kw["exclude_freq"],
                                 kw["exclude_lag"],
                                 lag_period=surf.shape[-1])
                vals, _, _ = apply_detection_threshold(
                    pks.value.cpu().numpy(), float(surf.double().mean()),
                    surf.numel(), min_snr)
                rows.append((freqs[pks.freq_idx.cpu().numpy()],
                             pks.lag_idx.cpu().numpy(), vals))
            lf, ll, lv = (np.stack(col) for col in zip(*rows))
    return [[(float(lf[i, p]), int(ll[i, p]), float(lv[i, p]))
             for p in range(args.num_peaks) if np.isfinite(float(lv[i, p]))]
            for i in range(len(needles))]


def cmd_bench(args) -> int:
    from caf_cookoff_tpu_torch.utils.bench import (apply_shift_microbench,
                                                   run_benchmarks)

    results = run_benchmarks(
        grid=_grid(args), sample_rate=args.fs or DEFAULT_SAMPLE_RATE,
        rounds=args.rounds,
        backends=args.backends.split(","), data_dir=args.data,
        device=args.device)
    micro = (apply_shift_microbench(device=args.device) if args.micro
             else None)
    if args.json:
        print(json.dumps(results + ([micro] if micro else []), indent=2))
        return 0
    if results:
        print(f"{results[0]['device']} ({results[0]['power_limit']})")
    print(f"{'strategy':<26}{'ms/surface':>11}{'surfaces/s':>11}"
          f"{'TFLOP/s':>9}{'MFU%':>7}  golden")
    for row in results:
        if row.get("error"):
            print(f"{row['strategy']:<26}{'—':>11}  {row['error']}")
        else:
            tf = f"{row['tflops']:>9.2f}" if "tflops" in row else f"{'—':>9}"
            mfu = (f"{row['mfu_pct']:>7.1f}" if "mfu_pct" in row
                   else f"{'—':>7}")
            print(f"{row['strategy']:<26}{row['ms']:>11.3f}"
                  f"{1e3 / row['ms']:>11.1f}{tf}{mfu}  "
                  f"{row.get('golden', '—')}")
    if micro:
        print(f"\napply_shift ({micro['samples']} samp): "
              f"{micro['us_per_call']} us  "
              f"(reference best {micro['reference_best_us']} us)")
    return 0


def cmd_selftest(args) -> int:
    """The ten golden fixtures through one backend: the injected (freq,
    lag) comes from each haystack's file name; an answer is exact when
    the lag equals it and the frequency lies within one grid step of
    it.  Exit 0 only if all ten are exact."""
    import contextlib
    import tempfile

    from caf_cookoff_tpu_torch.models.filterbank import caf_peak
    from caf_cookoff_tpu_torch.utils.generate import ensure_fixtures
    from caf_cookoff_tpu_torch.utils.io import load_c64, parse_ground_truth

    with contextlib.ExitStack() as stack:
        data_dir = args.data or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="caf_selftest_"))
        pairs = ensure_fixtures(data_dir)
        grid = FreqGrid(-100.0, 100.0, 0.25)
        freqs = grid.frequencies(np.float32)
        failures = 0
        for n_path, h_path in pairs:
            truth = parse_ground_truth(h_path)
            needle = load_c64(n_path)
            hay = load_c64(h_path, count=len(needle))
            freq, lag, _ = caf_peak(needle, hay, freqs, DEFAULT_SAMPLE_RATE,
                                    backend=args.backend, device=args.device)
            if (lag == truth.lag_samples
                    and abs(freq - truth.freq_hz) <= grid.step_hz):
                print(f"chirp_{truth.index}: ok ({freq:+.2f} Hz, lag {lag})")
            else:
                failures += 1
                print(f"chirp_{truth.index}: FAIL got ({freq:+.2f}, {lag}) "
                      f"want ({truth.freq_hz:+.2f} +-{grid.step_hz}, "
                      f"{truth.lag_samples})")
        total = len(pairs)
        print(f"{total - failures}/{total} golden fixtures exact "
              f"(backend={args.backend})")
        return 1 if failures else 0


def cmd_info(args) -> int:
    import torch

    from caf_cookoff_tpu_torch.config import resolve_backend
    from caf_cookoff_tpu_torch.ops import _build
    from caf_cookoff_tpu_torch.utils.bench import nvidia_smi_card

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count:
        names = sorted({torch.cuda.get_device_name(i) for i in range(count)})
        print(f"cards: {count} x {', '.join(names)}")
    else:
        print("cards: none (torch sees no CUDA card; compute verbs need "
              "--device cpu)")
    print(f"nvidia-smi: {nvidia_smi_card() or 'not available'}")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    print(f"nvcc: {nvcc or 'not found'}")
    lib = _build.library_path()
    print(f"kernel library: {lib if lib.exists() else 'not built'} "
          f"(built at first kernel launch)")
    print(f"resolved FFT backend: {resolve_backend('auto')} (torch.fft: "
          f"{'cuFFT' if count else 'pocketfft'})")
    from caf_cookoff_tpu_torch.utils import native

    state = ("loaded" if native.available()
             else "absent (numpy fallback; g++ builds it from "
             "native/cafio.cpp at first use)")
    print(f"native libcafio: {state}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m caf_cookoff_tpu_torch",
        description="cross-ambiguity-function engine (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="synthesize the chirp fixtures")
    g.add_argument("--out", default="data", help="output directory")
    g.add_argument("--count", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="CAF one (needle, haystack) pair, .c64 "
                       "or SigMF (haystack truncated to the needle length "
                       "unless --full-haystack)")
    r.add_argument("needle", help=".c64 or .sigmf needle (signal of "
                   "interest)")
    r.add_argument("haystack", help=".c64 or .sigmf haystack (capture)")
    _add_grid_args(r)
    r.add_argument("--backend", choices=BACKENDS, default="auto",
                   help=_BACKEND_HELP)
    r.add_argument("--full-haystack", action="store_true",
                   help="search the whole capture (segmented long-capture "
                   "engine, overlap-save scan as its fallback)")
    r.add_argument("--num-peaks", type=int, default=1,
                   help="list the N strongest peaks (multi-emitter, "
                   "non-max suppressed)")
    r.add_argument("--min-snr-db", default="auto",
                   help="detection threshold over the noise floor for "
                   "--num-peaks listings: 'auto' (from the searched cell "
                   "count at 1e-3 false alarm), 'none', or a dB value")
    r.add_argument("--refine", action="store_true",
                   help="zoom re-score the peak (and each --num-peaks row) "
                   "to continuous (freq, lag)")
    r.add_argument("--rate", action="store_true",
                   help="also estimate a linear doppler rate (Hz/s) by the "
                   "second-order (freq, rate, lag) zoom")
    r.add_argument("--rate-grid", metavar="START:STOP:STEP",
                   help="search this rate grid (Hz/s): the dechirp bank on "
                   "the truncated pair, the segmented rate engine (serial "
                   "scan as its fallback) with --full-haystack, and with "
                   "--num-peaks N the N strongest accelerating emitters; "
                   "then the joint (freq, rate, lag) refine")
    r.add_argument("--segment", type=int, default=None,
                   help="capture segment index for multi-capture SigMF "
                   "recordings (lags count from the segment start; "
                   "annotations rebase to absolute indices)")
    r.add_argument("--dump-surface", metavar="PATH",
                   help="write the surface (.npy, or raw little-endian f64 "
                   "rows)")
    r.add_argument("--plot", metavar="PNG", help="save an imshow plot of "
                   "the surface")
    r.add_argument("--annotate", action="store_true",
                   help="write the detection back to the haystack's "
                   ".sigmf-meta as a caf: annotation")
    r.add_argument("--device", default=None, help=_DEVICE_HELP)
    r.set_defaults(fn=cmd_run)

    st = sub.add_parser("stream", help="chunk-at-a-time CAF of a capture "
                        "(StreamingCAF)")
    st.add_argument("needle", help=".c64 or .sigmf needle")
    st.add_argument("capture", help=".c64 or .sigmf capture (any length)")
    _add_grid_args(st)
    st.add_argument("--backend", choices=BACKENDS, default="auto",
                    help="stein: K1 once a chunk and an exact re-score of "
                    "the carried best windows (with --num-peaks, same-bin "
                    "pairs more than one exclusion cell apart); any other "
                    "name: cuFFT steps")
    st.add_argument("--chunk", type=int, default=4096,
                    help="samples per streamed chunk")
    st.add_argument("--verbose", action="store_true",
                    help="print each chunk's local peak")
    st.add_argument("--num-peaks", type=int, default=1,
                    help="track a top-N multi-emitter lattice through the "
                    "stream (NMS windows sized to the waveform's "
                    "resolution cell)")
    st.add_argument("--min-snr-db", default="auto",
                    help="detection threshold over the stream's running "
                    "noise floor for --num-peaks listings: 'auto', 'none', "
                    "or a dB value")
    st.add_argument("--refine", action="store_true",
                    help="zoom re-score the final peak(s) to continuous "
                    "(freq, lag); file-backed streams only (--follow "
                    "discards consumed samples)")
    st.add_argument("--segment", type=int, default=None,
                    help="capture segment of a multi-capture SigMF "
                    "recording to stream")
    st.add_argument("--follow", action="store_true",
                    help="tail a growing .sigmf-data file (ends after "
                    "--idle-timeout without growth)")
    st.add_argument("--idle-timeout", type=float, default=5.0,
                    help="seconds without file growth before --follow "
                    "ends")
    st.add_argument("--device", default=None, help=_DEVICE_HELP)
    st.set_defaults(fn=cmd_stream)

    c = sub.add_parser("capture", help="record a live audio-band SigMF "
                       "capture (optional sounddevice package; no torch "
                       "device)")
    c.add_argument("out", help="output base path (.sigmf-data/-meta)")
    c.add_argument("--fs", type=float, default=None,
                   help=f"sample rate (default {DEFAULT_SAMPLE_RATE:g})")
    c.add_argument("--seconds", type=float, default=5.0)
    c.add_argument("--device", type=int, default=None,
                   help="sounddevice input index (not a torch device: "
                   "capture computes nothing)")
    c.set_defaults(fn=cmd_capture)

    bt = sub.add_parser("batch", help="CAF many needle:capture pairs (.c64 "
                        "or SigMF) through the batched Stein engines")
    bt.add_argument("pairs", nargs="+", metavar="NEEDLE:CAPTURE",
                    help="colon-separated .c64 / .sigmf path pairs")
    _add_grid_args(bt)
    bt.add_argument("--backend", choices=BACKENDS, default="auto",
                    help="backend of the per-pair fallback runs")
    bt.add_argument("--full-haystack", action="store_true",
                    help="search whole captures (windowed engine)")
    bt.add_argument("--json", action="store_true")
    bt.add_argument("--num-peaks", type=int, default=1,
                    help="top-N multi-emitter lattice per pair (NMS "
                    "windows sized to the first needle's resolution cell)")
    bt.add_argument("--min-snr-db", default="auto",
                    help="per-pair detection threshold for --num-peaks "
                    "lattices: 'auto', 'none', or a dB value")
    bt.add_argument("--refine", action="store_true",
                    help="batched zoom re-score of every pair's answer to "
                    "continuous (freq, lag)")
    bt.add_argument("--device", default=None, help=_DEVICE_HELP)
    bt.set_defaults(fn=cmd_batch)

    b = sub.add_parser("bench", help="README-style strategy table, timed "
                       "on the CUDA card")
    _add_grid_args(b)
    b.add_argument("--rounds", type=int, default=3,
                   help="timing rounds (reference uses 3, caf.py:137)")
    b.add_argument("--backends", default="xla,matmul,stein",
                   help="comma list, or 'all' for every backend "
                   "(xla, matmul[-highest|-bf16], pallas[-bf16|-refine], "
                   "stein[-raw])")
    b.add_argument("--data", default="data")
    b.add_argument("--json", action="store_true")
    b.add_argument("--micro", action="store_true",
                   help="include the apply_shift microbench")
    b.add_argument("--device", default="cuda",
                   help="CUDA device to time (a non-CUDA device fails)")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("selftest", help="run the 10 golden fixtures; "
                        "exit 0 iff all exact")
    st.add_argument("--backend", choices=BACKENDS, default="auto",
                    help=_BACKEND_HELP)
    st.add_argument("--data", default=None,
                    help="fixture directory (default: a temp dir)")
    st.add_argument("--device", default=None, help=_DEVICE_HELP)
    st.set_defaults(fn=cmd_selftest)

    i = sub.add_parser("info", help="torch, card, nvcc, kernel library, "
                       "backend resolution and the native I/O library (no "
                       "tunnel probes: the card is local)")
    i.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
