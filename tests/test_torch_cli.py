"""The port's CLI verbs and bench harness against the JAX package's, on
the CPU (``--device cpu``: the port runs on the card unless asked)."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from caf_cookoff_tpu import cli as jcli
from caf_cookoff_tpu.utils import bench as jbench
from caf_cookoff_tpu_torch import cli as tcli
from caf_cookoff_tpu_torch.utils import bench as tbench

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

NARROW = ["--freq-start", "68", "--freq-stop", "74", "--freq-step", "0.25"]


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_run_pallas_refine_matches_jax_cli(fixture_pairs, capsys):
    """Same result lines as the JAX CLI on chirp_0 (24-bin grid: the JAX
    kernel runs in interpret mode here); the unnormalised peak value
    within rtol 1e-4."""
    needle, haystack = map(str, fixture_pairs[0])
    argv = ["run", needle, haystack, *NARROW, "--backend", "pallas-refine"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Frequency offset:", "Time offset:"):
        assert _lines(got, prefix) == _lines(want, prefix)
    assert _lines(got, "Time offset:") == [
        "Time offset: 202 samples (4.2083 ms)"]
    value = [float(_lines(out, "Peak value:")[0].split()[-1])
             for out in (got, want)]
    assert value[0] == pytest.approx(value[1], rel=1e-4)


def test_selftest_pallas_on_cpu(fixture_pairs, capsys):
    data_dir = str(pathlib.Path(fixture_pairs[0][0]).parent)
    rc = tcli.main(["selftest", "--backend", "pallas", "--device", "cpu",
                    "--data", data_dir])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "10/10 golden fixtures exact (backend=pallas)" in out
    assert "chirp_0: ok (+69.25 Hz, lag 202)" in out


def test_flops_model_matches_jax():
    assert tbench.ALL_BACKENDS == jbench.ALL_BACKENDS
    for backend in tbench.ALL_BACKENDS:
        for k, n, m in ((400, 4096, 8192), (37, 1000, 2048), (9, 96, 200)):
            assert tbench.flops_model(backend, k, n, m) == \
                jbench.flops_model(backend, k, n, m)


def test_measurements_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbench.run_benchmarks(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbench.apply_shift_microbench(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcli.main(["bench", "--device", "cpu"])


def test_info_names_no_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "cards: none" in out
    assert "nvcc:" in out and "kernel library:" in out
    assert "resolved FFT backend: xla" in out


def test_selftest_exits_1_on_a_wrong_answer(fixture_pairs, capsys,
                                            monkeypatch):
    """One wrong answer fails the run."""
    import caf_cookoff_tpu_torch.models.filterbank as tfb

    real = tfb.caf_peak

    def off_by_one_lag(*args, **kwargs):
        freq, lag, value = real(*args, **kwargs)
        return freq, lag + 1, value

    monkeypatch.setattr(tfb, "caf_peak", off_by_one_lag)
    data_dir = str(pathlib.Path(fixture_pairs[0][0]).parent)
    rc = tcli.main(["selftest", "--backend", "xla", "--device", "cpu",
                    "--data", data_dir])
    out = capsys.readouterr().out
    assert rc == 1
    assert "0/10 golden fixtures exact" in out
    assert out.count("FAIL") == 10


def _value(out, prefix="Peak value:"):
    return float(_lines(out, prefix)[0].split()[-1])


@pytest.mark.parametrize("backend,engine", [
    ("auto", "Engine: stein-os (segmented long-capture)"),
    ("xla", "Engine: overlap-save scan")])
def test_run_full_haystack_matches_jax_cli(fixture_pairs, capsys, backend,
                                           engine):
    """``run --full-haystack`` searches the whole capture file: the same
    result lines and engine line as the JAX CLI, the value within rtol
    1e-4 and, for the scan, the peak-to-floor SNR within 0.05 dB."""
    needle, haystack = map(str, fixture_pairs[0])
    argv = ["run", needle, haystack, "--full-haystack", "--freq-step",
            "0.25", "--backend", backend]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Frequency offset:", "Time offset:", "Engine:"):
        assert _lines(got, prefix) == _lines(want, prefix)
    assert _lines(got, "Engine:") == [engine]
    assert _lines(got, "Time offset:") == [
        "Time offset: 202 samples (4.2083 ms)"]
    assert _value(got) == pytest.approx(_value(want), rel=1e-4)
    snr = [re.search(r"peak/floor ([-\d.]+) dB", out) for out in (got, want)]
    if backend == "xla":
        assert float(snr[0].group(1)) == pytest.approx(
            float(snr[1].group(1)), abs=0.05)
    else:
        assert snr[0] is None


@pytest.mark.parametrize("full", [False, True])
def test_batch_matches_jax_cli(fixture_pairs, capsys, full):
    """``batch`` over two pairs (equal-length, or whole captures with
    ``--full-haystack``): the JAX CLI's records, values within rtol
    1e-4; the text lines agree up to the value."""
    specs = [f"{n}:{h}" for n, h in (fixture_pairs[0], fixture_pairs[3])]
    argv = ["batch", *specs, "--freq-step", "0.25"] + (
        ["--full-haystack"] if full else [])
    assert jcli.main(argv + ["--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(argv + ["--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert [(r["freq_hz"], r["lag_samples"]) for r in got] == \
        [(r["freq_hz"], r["lag_samples"]) for r in want] == \
        [(69.25, 202), (-76.25, 151)]
    for g, w in zip(got, want):
        assert g["peak_value"] == pytest.approx(w["peak_value"], rel=1e-4)
    assert jcli.main(argv) == 0
    want_txt = capsys.readouterr().out.splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got_txt = capsys.readouterr().out.splitlines()
    assert [ln.split("  peak")[0] for ln in got_txt] == \
        [ln.split("  peak")[0] for ln in want_txt]


def test_unported_options_name_the_roadmap_item(fixture_pairs, capsys):
    """``--refine`` (ROADMAP item 11) and ``--rate-grid`` (item 12), once
    refused with a "not ported yet" error, now run: exit 0 and print the
    JAX CLI's refine, rate and lattice lines."""
    needle, haystack = map(str, fixture_pairs[0])
    for argv, prefix in (
            (["run", needle, haystack, "--num-peaks", "2", "--refine"],
             "peak 1:"),
            (["run", needle, haystack, "--full-haystack",
              "--rate-grid=-300:300:150"], "Second-order estimate:"),
            (["batch", f"{needle}:{haystack}", "--num-peaks", "3",
              "--refine"], "    peak 1:")):
        assert tcli.main(argv + ["--device", "cpu"]) == 0
        out = capsys.readouterr()
        assert "not ported yet" not in out.err
        assert _lines(out.out, prefix)
        assert "refined" in out.out or "Second-order" in out.out


FS = 48_000.0
COARSE = ["--freq-step", "2.5"]
_PEAK = re.compile(r"^ *peak (\d+): +([-+\d.]+) Hz @ lag +(-?\d+) +\(([^,)]+)"
                   r"(?:, ([-\d.]+) dB)?\)$")


def _capture(tmp_path, tag, truths, n=1024, total=16384, seed=5):
    """A noise needle and a capture holding its copies at (freq_hz, lag,
    amp) truths, written as .c64 files: their paths."""
    import numpy as np

    from caf_cookoff_tpu_torch.utils.io import write_c64

    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f, lag, amp in truths:
        shifted = np.roll(np.pad(amp * needle * np.exp(
            2j * np.pi * f * t / FS), (0, max(total - n, 0))), lag)[:total]
        hay += shifted.astype(np.complex64)
    paths = [str(tmp_path / f"{tag}_{x}.c64") for x in ("n", "c")]
    write_c64(paths[0], needle)
    write_c64(paths[1], hay)
    return paths


def _same_lattice(got, want, rel=1.1e-4):
    """The same lattice listing: identical "peak i:" lines up to the
    value (freq, lag, tags) and the same "Detections:" line; values
    within the printed 5 digits, SNRs within the printed 0.1 dB."""
    rows = [[_PEAK.match(ln) for ln in out.splitlines()
             if "peak " in ln and " Hz @ lag" in ln] for out in (got, want)]
    assert len(rows[0]) == len(rows[1]) > 0
    for g, w in zip(*rows):
        assert g.group(1, 2, 3) == w.group(1, 2, 3)
        assert float(g.group(4)) == pytest.approx(float(w.group(4)), rel=rel)
        if w.group(5) is not None:
            assert float(g.group(5)) == pytest.approx(float(w.group(5)),
                                                      abs=0.1)
    for prefix in ("Detections:", "peak"):
        tags = [[ln for ln in out.splitlines() if ln.startswith(prefix)
                 and "(" in ln and " Hz" not in ln] for out in (got, want)]
        assert tags[0] == tags[1]
    return [r.group(2, 3) for r in rows[0]]


@pytest.mark.parametrize("full", [False, True])
def test_run_num_peaks_matches_jax_cli(tmp_path, capsys, full):
    """``run --num-peaks``: on the truncated pair (``find_peaks`` on the
    circular surface, signed lags) and with ``--full-haystack`` (the
    fused long-capture lattice): the JAX CLI's lattice listing."""
    if full:
        truths = ((-30.0, 3000, 1.0), (45.0, 9000, 0.8), (10.0, 14000, 0.6))
        extra, num = ["--full-haystack"], "3"
    else:
        truths = ((-30.0, 200, 1.0), (45.0, 600, 0.7))
        extra, num = [], "2"
    needle, cap = _capture(tmp_path, "run", truths)
    argv = ["run", needle, cap, *COARSE, "--num-peaks", num, *extra]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    rows = _same_lattice(got, want)
    assert [(float(f), int(lag)) for f, lag in rows[:len(truths)]] == \
        [(f, lag) for f, lag, _ in truths]
    assert _lines(got, "Detections:") == _lines(want, "Detections:") != []


@pytest.mark.parametrize("full,min_snr", [(False, "auto"), (True, "auto"),
                                          (True, "none")])
def test_batch_num_peaks_matches_jax_cli(tmp_path, capsys, full, min_snr):
    """``batch --num-peaks 3`` over two pairs (equal-length through the
    fused batch lattice, or whole captures through the fused long-capture
    lattice): the JAX CLI's records and peak lines."""
    specs, truths = [], []
    for b in range(2):
        es = (((-30.0 + 5 * b, 3000 + 100 * b, 1.0),
               (40.0, 9000 + 200 * b, 0.7)) if full else
              ((-30.0 + 5 * b, 100 + 50 * b, 1.0),
               (40.0, 600 + 20 * b, 0.7)))
        truths.append([(f, lag) for f, lag, _ in es])
        specs.append(":".join(_capture(tmp_path, f"p{b}", es, seed=5 + b)))
    argv = (["batch", *specs, *COARSE, "--num-peaks", "3", "--min-snr-db",
             min_snr] + (["--full-haystack"] if full else []))
    assert jcli.main(argv + ["--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(argv + ["--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    for g, w, es in zip(got, want, truths):
        rows = [(p["freq_hz"], p["lag_samples"]) for p in g["peaks"]]
        assert rows == [(p["freq_hz"], p["lag_samples"])
                        for p in w["peaks"]]
        # A truncated pair holds only part of the later copy, whose
        # doppler then smears: its lag is exact, its bin need not be.
        assert rows[:2] == es if full else [r[1] for r in rows[:2]] == \
            [e[1] for e in es]
        for gp, wp in zip(g["peaks"], w["peaks"]):
            assert gp["peak_value"] == pytest.approx(wp["peak_value"],
                                                     rel=2e-5)
    assert jcli.main(argv) == 0
    want_txt = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got_txt = capsys.readouterr().out
    assert [ln.split("  (")[0] for ln in got_txt.splitlines()
            if ln.startswith("    peak")] == \
        [ln.split("  (")[0] for ln in want_txt.splitlines()
         if ln.startswith("    peak")]


# ---------------------------------------------------------------------------
# --refine, --rate and --rate-grid
# ---------------------------------------------------------------------------

_FLOAT = r"([-+]?\d+\.?\d*(?:e[-+]?\d+)?)"


def _floats(line):
    return [float(x) for x in re.findall(_FLOAT, line)]


def _write_swept(tmp_path, tag, emitters, n=1024, total=8192, seed=8):
    """A noise needle and a capture of its swept copies (f0 at the window
    start, rate Hz/s, lag, amplitude), written as .c64 files."""
    import numpy as np

    from caf_cookoff_tpu_torch.utils.io import write_c64

    rng = np.random.default_rng(seed)
    needle = (rng.standard_normal(n)
              + 1j * rng.standard_normal(n)).astype(np.complex64)
    hay = (1e-4 * (rng.standard_normal(total)
                   + 1j * rng.standard_normal(total))).astype(np.complex64)
    t = np.arange(n)
    for f0, rate, lag, amp in emitters:
        end = min(lag + n, total)
        hay[lag:end] += (amp * needle * np.exp(
            2j * np.pi * f0 * t / FS + 1j * np.pi * rate * (t / FS) ** 2)
        ).astype(np.complex64)[:end - lag]
    paths = [str(tmp_path / f"{tag}_{x}.c64") for x in ("n", "c")]
    write_c64(paths[0], needle)
    write_c64(paths[1], hay)
    return paths


def _both(argv, capsys):
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    return capsys.readouterr().out, want


def test_run_refine_and_rate_match_jax_cli(fixture_pairs, capsys):
    """``run --refine --rate`` on chirp_1's 1 Hz grid (the reference's
    36.0 Hz snap of +35.99): the same result lines; both zoom estimates
    within 0.01 Hz and 0.1 samples of the truth (78); the second-order
    estimate, whose last stage is a host f64 polish in both packages,
    within 1e-3 Hz, 0.05 Hz/s and 1e-3 samples of JAX's."""
    needle, haystack = map(str, fixture_pairs[1])
    got, want = _both(["run", needle, haystack, "--freq-start", "30",
                       "--freq-stop", "40", "--freq-step", "1.0",
                       "--refine", "--rate"], capsys)
    for prefix in ("Frequency offset:", "Time offset:"):
        assert _lines(got, prefix) == _lines(want, prefix)
    for out in (got, want):
        f_ref, t_ref = _floats(_lines(out, "Refined estimate:")[0])[:2]
        assert abs(f_ref - 35.99) <= 0.01 and abs(t_ref - 78) <= 0.1
    g, w = (_floats(_lines(out, "Second-order estimate:")[0])[:3]
            for out in (got, want))
    assert abs(g[0] - w[0]) <= 1e-3 and abs(g[1] - w[1]) <= 0.05
    assert abs(g[2] - w[2]) <= 1e-3


def _close_second_order(got_line, want_line):
    g, w = _floats(got_line)[:3], _floats(want_line)[:3]
    assert abs(g[0] - w[0]) <= 1e-3 and abs(g[1] - w[1]) <= 0.05
    assert abs(g[2] - w[2]) <= 1e-3
    return g


@pytest.mark.parametrize("route", ["bank", "full", "lattice"])
def test_run_rate_grid_matches_jax_cli(tmp_path, capsys, route):
    """``run --rate-grid``: the dechirp bank on the truncated pair, the
    segmented rate engine over the whole capture, and with ``--num-peaks
    3 --refine`` its lattice with each row refined: integer fields
    (rate, lag, bins) identical to the JAX CLI's, values within 1e-4,
    refined floats within 1e-3 Hz, 0.05 Hz/s and 1e-3 samples."""
    grid = ["--freq-start", "-100", "--freq-stop", "100", "--freq-step",
            "1.0", "--rate-grid=-240:240:120"]
    if route == "bank":
        needle, cap = _write_swept(tmp_path, route, [(20.0, 240.0, 137, 1.0)],
                                   n=2048, total=2048)
        argv = ["run", needle, cap, *grid]
    else:
        emitters = [(25.0, 120.0, 3000, 1.0), (-60.0, -120.0, 6500, 0.6)]
        needle, cap = _write_swept(tmp_path, route, emitters)
        argv = ["run", needle, cap, "--full-haystack", *grid]
        if route == "lattice":
            argv += ["--num-peaks", "3", "--refine"]
    got, want = _both(argv, capsys)
    if route != "lattice":
        g, w = (_lines(out, "Rate-bank peak:")[0] for out in (got, want))
        assert g.split("(")[0] == w.split("(")[0]
        assert _floats(g)[-1] == pytest.approx(_floats(w)[-1], rel=1e-4)
        rate, lag = (137, 240.0) if route == "bank" else (3000, 120.0)
        assert f"{lag:+.1f} Hz/s @ lag {rate}" in g
        _close_second_order(_lines(got, "Second-order estimate:")[0],
                            _lines(want, "Second-order estimate:")[0])
        return
    rows = [[ln for ln in out.splitlines() if ln.startswith("peak ")]
            for out in (got, want)]
    assert len(rows[0]) == len(rows[1]) == 3
    assert _lines(got, "Detections:") == _lines(want, "Detections:") != []
    for g, w in zip(*rows):
        assert g.split("(")[0] == w.split("(")[0]       # freq, rate, lag
        if "refined" in w:
            gv, wv = _floats(g.split("(")[1]), _floats(w.split("(")[1])
            assert gv[0] == pytest.approx(wv[0], rel=1e-4)
            assert abs(gv[1] - wv[1]) <= 0.1                   # SNR dB
            _close_second_order(g.split("refined")[1], w.split("refined")[1])
    assert "+120.0 Hz/s @ lag   3000" in rows[0][0]
    assert "-120.0 Hz/s @ lag   6500" in rows[0][1]


def test_run_num_peaks_refine_matches_jax_cli(tmp_path, capsys):
    """``run --full-haystack --num-peaks 2 --refine``: the JAX CLI's rows,
    each refined within 0.01 Hz and 0.1 samples of its truth."""
    truths = ((-30.0, 3000, 1.0), (45.0, 9000, 0.7))
    needle, cap = _capture(tmp_path, "nr", truths)
    got, want = _both(["run", needle, cap, *COARSE, "--full-haystack",
                       "--num-peaks", "2", "--refine"], capsys)
    rows = [[ln for ln in out.splitlines() if ln.startswith("peak ")]
            for out in (got, want)]
    for g, w, (f, lag, _) in zip(*rows, truths):
        assert g.split("(")[0] == w.split("(")[0]
        for line in (g, w):
            f_ref, t_ref = _floats(line.split("refined")[1])[:2]
            assert abs(f_ref - f) <= 0.01 and abs(t_ref - lag) <= 0.1


@pytest.mark.parametrize("full", [False, True])
def test_batch_refine_matches_jax_cli(fixture_pairs, capsys, full):
    """``batch --refine`` over two goldens (equal-length, or whole
    captures): the JAX CLI's records; both packages' refined estimates
    within 0.01 Hz and 0.1 samples of the injected truth, read from the
    whole captures."""
    from caf_cookoff_tpu_torch.utils.io import parse_ground_truth

    pairs = (fixture_pairs[0], fixture_pairs[3])
    argv = ["batch", *[f"{n}:{h}" for n, h in pairs], "--freq-step", "0.25",
            "--refine", "--json"] + (["--full-haystack"] if full else [])
    got, want = (json.loads(out) for out in _both(argv, capsys))
    for g, w, (_, h) in zip(got, want, pairs):
        assert list(g) == list(w)
        assert (g["freq_hz"], g["lag_samples"]) == \
            (w["freq_hz"], w["lag_samples"])
        gt = parse_ground_truth(h)
        for rec in (g, w):
            assert abs(rec["refined_freq_hz"] - gt.freq_hz) <= 0.01
            assert abs(rec["refined_lag_samples"] - gt.lag_samples) <= 0.1
    txt = _both([a for a in argv if a != "--json"], capsys)
    assert all("  refined " in ln for out in txt for ln in out.splitlines())


# ---------------------------------------------------------------------------
# SigMF input on run and batch
# ---------------------------------------------------------------------------

WIDE = ["--freq-start", "-200", "--freq-stop", "200", "--freq-step", "0.25",
        "--backend", "xla"]


def _as_sigmf(tmp_path, pairs, rate, dtype="cf32"):
    """The fixture pairs rewritten as SigMF recordings at ``rate`` (the
    same samples, so at 96 kHz every doppler doubles): [(needle base,
    haystack base)]."""
    import numpy as np

    from caf_cookoff_tpu_torch.utils.io import load_c64
    from caf_cookoff_tpu_torch.utils.sigmf import write_sigmf

    out = []
    for i, pair in enumerate(pairs):
        bases = []
        for tag, path in zip(("n", "h"), pair):
            x = load_c64(str(path))
            if dtype == "cf64":
                x = x.astype(np.complex128)
            base = str(tmp_path / f"{tag}{i}_{int(rate)}_{dtype}")
            write_sigmf(base, x, rate)
            bases.append(base)
        out.append(tuple(bases))
    return out


def _run_both(argv, capsys):
    assert jcli.main(argv) == 0
    want = capsys.readouterr()
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    return got, want


@pytest.mark.parametrize("rate,dtype,ext", [
    (48_000.0, "cf32", ".sigmf-meta"), (48_000.0, "cf32", ".sigmf-data"),
    (96_000.0, "cf32", ".sigmf-meta"), (96_000.0, "cf64", ".sigmf-data")])
def test_run_sigmf_matches_jax_cli(fixture_pairs, tmp_path, capsys, rate,
                                   dtype, ext):
    """``run`` on SigMF recordings (either sidecar, cf32 or cf64) prints
    the JAX CLI's result lines; at 96 kHz both read the recording's rate
    (chirp_0's 69.25 Hz doubles) with the JAX CLI's note."""
    (n_base, h_base), = _as_sigmf(tmp_path, fixture_pairs[:1], rate, dtype)
    got, want = _run_both(["run", n_base + ext, h_base + ext, *WIDE], capsys)
    for prefix in ("Frequency offset:", "Time offset:"):
        assert _lines(got.out, prefix) == _lines(want.out, prefix)
    scale = rate / 48_000.0
    assert _lines(got.out, "Frequency offset:") == [
        f"Frequency offset: {69.25 * scale:.3f} Hz"]
    assert _lines(got.out, "Time offset:") == [
        f"Time offset: 202 samples ({202 / rate * 1e3:.4f} ms)"]
    assert _value(got.out) == pytest.approx(_value(want.out), rel=1e-4)
    note = "note: using the recording's core:sample_rate 96000 Hz"
    assert (note in got.err) == (note in want.err) == (rate == 96_000.0)


@pytest.mark.parametrize("full", [False, True])
def test_batch_sigmf_matches_jax_cli(fixture_pairs, tmp_path, capsys, full):
    """``batch`` over two SigMF pairs at 96 kHz (meta and data sidecars
    mixed): the JAX CLI's records, lag_ms at the recording's rate."""
    pairs = _as_sigmf(tmp_path, (fixture_pairs[0], fixture_pairs[3]),
                      96_000.0)
    specs = [f"{pairs[0][0]}.sigmf-meta:{pairs[0][1]}.sigmf-data",
             f"{pairs[1][0]}.sigmf-data:{pairs[1][1]}.sigmf-meta"]
    argv = ["batch", *specs, "--json", *WIDE[:-2]] + (
        ["--full-haystack"] if full else [])
    got, want = _run_both(argv, capsys)
    got, want = json.loads(got.out), json.loads(want.out)
    assert [(r["freq_hz"], r["lag_samples"], r["lag_ms"]) for r in got] == \
        [(r["freq_hz"], r["lag_samples"], r["lag_ms"]) for r in want] == \
        [(138.5, 202, 202 / 96.0), (-152.5, 151, 151 / 96.0)]
    for g, w in zip(got, want):
        assert g["peak_value"] == pytest.approx(w["peak_value"], rel=1e-4)


def test_run_sigmf_segment_matches_jax_cli(fixture_pairs, tmp_path, capsys):
    """``--segment 1`` of a two-capture recording (noise, then chirp_0's
    haystack) searches that segment alone, lags counted from its start,
    as the JAX CLI does; without it both note the segments and search
    the whole stream; ``--segment`` on a .c64 path is refused by both."""
    import numpy as np

    from caf_cookoff_tpu_torch.utils.io import load_c64
    from caf_cookoff_tpu_torch.utils.sigmf import write_sigmf

    needle_path, hay_path = map(str, fixture_pairs[0])
    hay = load_c64(hay_path)
    rng = np.random.default_rng(4)
    noise = (0.05 * (rng.standard_normal(3000)
                     + 1j * rng.standard_normal(3000))).astype(np.complex64)
    base = str(tmp_path / "two")
    write_sigmf(base, np.concatenate([noise, hay]), 48_000.0,
                captures=[{"core:sample_start": 0},
                          {"core:sample_start": 3000}])
    argv = ["run", needle_path, base + ".sigmf-meta", *NARROW, "--backend",
            "xla"]
    got, want = _run_both(argv + ["--segment", "1"], capsys)
    for prefix in ("Frequency offset:", "Time offset:"):
        assert _lines(got.out, prefix) == _lines(want.out, prefix)
    assert _lines(got.out, "Time offset:") == [
        "Time offset: 202 samples (4.2083 ms)"]
    got, want = _run_both(argv, capsys)
    assert "has 2 capture segments" in got.err
    assert "has 2 capture segments" in want.err
    for prefix in ("Frequency offset:", "Time offset:"):
        assert _lines(got.out, prefix) == _lines(want.out, prefix)
    for main in (jcli.main, tcli.main):
        with pytest.raises(ValueError, match="only to SigMF"):
            main(["run", needle_path, hay_path, "--segment", "1",
                  "--device", "cpu"] if main is tcli.main else
                 ["run", needle_path, hay_path, "--segment", "1"])


def test_run_sigmf_explicit_fs_conflict(fixture_pairs, tmp_path, capsys):
    """An explicit ``--fs`` that disagrees with the recording wins, with
    the JAX CLI's warning; one that agrees is silent; .c64 input keeps
    the 48 kHz default."""
    (n_base, h_base), = _as_sigmf(tmp_path, fixture_pairs[:1], 96_000.0)
    paths = [n_base + ".sigmf-meta", h_base + ".sigmf-meta"]
    got, want = _run_both(["run", *paths, *WIDE, "--fs", "48000"], capsys)
    warn = ("WARNING: --fs=48000 != recording core:sample_rate 96000; "
            "doppler estimates use --fs")
    assert warn in got.err and warn in want.err
    assert _lines(got.out, "Frequency offset:") == _lines(
        want.out, "Frequency offset:") == ["Frequency offset: 69.250 Hz"]
    got, want = _run_both(["run", *paths, *WIDE, "--fs", "96000"], capsys)
    assert "core:sample_rate" not in got.err + want.err
    assert _lines(got.out, "Frequency offset:") == [
        "Frequency offset: 138.500 Hz"]
    got, _ = _run_both(["run", *map(str, fixture_pairs[0]), *WIDE], capsys)
    assert _lines(got.out, "Frequency offset:") == [
        "Frequency offset: 69.250 Hz"]


_TIMED = re.compile(r", [\d.]+ ms/surface, [\d.]+ surfaces/s")
_P2F = re.compile(r"peak/floor ([-\d.inf]+) dB")


def _masked(out):
    """``out`` with the bracketed line's timing taken out (a CLI times a
    second call only when the first took under 2 s, which JAX's
    interpret-mode kernels do not), peak/floor masked and the peak value
    taken out: (lines, dB, value)."""
    db = _P2F.search(out)
    lines = [_P2F.sub("peak/floor X dB", _TIMED.sub("", ln))
             for ln in out.splitlines() if not ln.startswith("Peak value:")]
    return lines, db and float(db.group(1)), _value(out)


@pytest.mark.parametrize("backend,grid", [
    ("auto", ["--freq-step", "0.25"]), ("stein", ["--freq-step", "0.25"]),
    ("pallas-refine", NARROW)])
def test_run_report_lines_match_jax_cli(fixture_pairs, tmp_path, capsys,
                                        backend, grid):
    """``run``'s lines in the JAX CLI's order — the two result lines, the
    bracketed peak/floor, ms/surface, surfaces/s and backend line, the
    peak value, ``Engine: filterbank[...]`` and the artifact lines — equal
    to JAX's up to the timed numbers; peak/floor within 0.05 dB, the peak
    value and the dumped surface (``.npy``) within rtol 1e-4 (atol 1e-5
    of the surface's max)."""
    needle, haystack = map(str, fixture_pairs[0])
    paths = [str(tmp_path / f"{who}.npy") for who in ("jax", "port")]
    assert jcli.main(["run", needle, haystack, *grid, "--backend", backend,
                      "--dump-surface", paths[0]]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["run", needle, haystack, *grid, "--backend", backend,
                      "--dump-surface", paths[1], "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    (g_lines, g_db, g_v), (w_lines, w_db, w_v) = _masked(got), _masked(want)
    assert [ln.replace(paths[1], "S") for ln in g_lines] == \
        [ln.replace(paths[0], "S") for ln in w_lines]
    name = "xla" if backend == "auto" else backend
    assert g_lines[2] == f"[peak/floor X dB, {name}]"
    assert g_lines[3] == f"Engine: filterbank[{name}]"
    if backend == "auto":
        assert re.search(r"\[peak/floor [\d.]+ dB, [\d.]+ ms/surface, "
                         r"[\d.]+ surfaces/s, xla\]", got)
    assert g_db == pytest.approx(w_db, abs=0.05)
    assert g_v == pytest.approx(w_v, rel=1e-4)
    import numpy as np

    surf, jsurf = np.load(paths[1]), np.load(paths[0])
    assert surf.shape == jsurf.shape
    np.testing.assert_allclose(surf, jsurf, rtol=1e-4,
                               atol=1e-5 * float(jsurf.max()))


def test_run_full_haystack_artifacts_match_jax_cli(fixture_pairs, tmp_path,
                                                   capsys):
    """``--full-haystack`` with a raw f64 dump (the Go reference's rows)
    and a plot: the whole overlap-save surface (800 x 299 cells, under
    the 2**26 limit) as JAX writes it, peak/floor from it within 0.05
    dB, ``Engine: stein-os``, ``--num-peaks`` rows scanned over the
    capture and a refined estimate — the JAX CLI's lines."""
    import numpy as np

    from caf_cookoff_tpu_torch.utils.io import load_surf

    needle, haystack = map(str, fixture_pairs[0])
    outs = []
    for main, who, extra in ((jcli.main, "jax", []),
                             (tcli.main, "port", ["--device", "cpu"])):
        argv = ["run", needle, haystack, "--full-haystack", "--freq-step",
                "0.25", "--num-peaks", "2", "--refine", "--dump-surface",
                str(tmp_path / f"{who}.f64"), "--plot",
                str(tmp_path / f"{who}.png"), *extra]
        assert main(argv) == 0
        out = capsys.readouterr().out
        outs.append(out.replace(who, "W"))
    (w_lines, w_db, w_v), (g_lines, g_db, g_v) = map(_masked, outs)
    refined = [ln for ln in g_lines if "efined" in ln]
    assert [ln for ln in g_lines if "efined" not in ln] == \
        [ln for ln in w_lines if "efined" not in ln]
    assert "Engine: stein-os (segmented long-capture)" in g_lines
    assert "surface (800x299) -> " + str(tmp_path / "W.f64") in g_lines
    assert g_db == pytest.approx(w_db, abs=0.05)
    assert g_v == pytest.approx(w_v, rel=1e-4)
    for g, w in zip(refined, [ln for ln in w_lines if "efined" in ln]):
        assert np.allclose(_floats(g), _floats(w), atol=0.01)
    surf, jsurf = (load_surf(tmp_path / f"{who}.f64", 800)
                   for who in ("port", "jax"))
    np.testing.assert_allclose(surf, jsurf, rtol=1e-4,
                               atol=1e-5 * float(jsurf.max()))
    assert (tmp_path / "port.png").stat().st_size > 0


def test_run_full_haystack_windowed_surface(fixture_pairs, tmp_path, capsys,
                                            monkeypatch):
    """Past ``FULL_SURFACE_CELLS`` the artifacts are the needle-length
    window at the found lag (lags from ``lag_origin``), with the JAX
    CLI's note: the dump equals ``caf_surface`` of that window."""
    import numpy as np

    from caf_cookoff_tpu_torch.models.filterbank import caf_surface
    from caf_cookoff_tpu_torch.utils.io import load_c64

    needle, haystack = map(str, fixture_pairs[0])
    monkeypatch.setattr(tcli, "FULL_SURFACE_CELLS", 1000)
    path = str(tmp_path / "win.npy")
    assert tcli.main(["run", needle, haystack, "--full-haystack", *NARROW,
                      "--backend", "xla", "--dump-surface", path,
                      "--device", "cpu"]) == 0
    out = capsys.readouterr()
    origin = 202 - 64
    assert f"surface (24x8192) -> {path}, lag axis offset +{origin}" in \
        out.out
    assert f"4096-sample window at lag {origin}" in out.err
    n, h = load_c64(needle), load_c64(haystack)
    freqs = np.arange(68, 74, 0.25, dtype=np.float32)
    want = caf_surface(n, h[origin:origin + len(n)], freqs, FS,
                       device="cpu").numpy()
    np.testing.assert_allclose(np.load(path), want, rtol=1e-6)


def test_run_annotate_matches_jax_cli(fixture_pairs, tmp_path, capsys):
    """``--annotate`` writes the detection into the haystack's
    .sigmf-meta as the JAX CLI does (its own copy of the recording)."""
    import json as _json

    (n_base, h_base), = _as_sigmf(tmp_path, fixture_pairs[:1], 48_000.0)
    import shutil

    metas = []
    for main, who, extra in ((jcli.main, "jax", []),
                             (tcli.main, "port", ["--device", "cpu"])):
        base = f"{h_base}_{who}"
        for ext in (".sigmf-meta", ".sigmf-data"):
            shutil.copy(h_base + ext, base + ext)
        assert main(["run", n_base + ".sigmf-meta", base + ".sigmf-meta",
                     *NARROW, "--annotate", *extra]) == 0
        assert f"annotation -> {base}.sigmf-meta" in capsys.readouterr().out
        with open(base + ".sigmf-meta") as f:
            metas.append(_json.load(f)["annotations"])
    (ann,), (jann,) = metas[1], metas[0]
    value = "caf:peak_value"
    assert ann[value] == pytest.approx(jann[value], rel=1e-4)
    assert {k: v for k, v in ann.items() if k != value} == \
        {k: v for k, v in jann.items() if k != value}
    assert ann["core:sample_start"] == 202


def _stream_lines(out):
    """``stream`` output split for comparison: the lines with their
    numbers masked, and each line's numbers."""
    masked = [re.sub(_FLOAT, "#", ln) for ln in out.splitlines()]
    return masked, [_floats(ln) for ln in out.splitlines()]


@pytest.mark.parametrize("backend", ["stein", "xla"])
def test_stream_matches_jax_cli(fixture_pairs, capsys, backend):
    """``stream`` of chirp_0's capture in 2048-sample chunks with
    ``--verbose --num-peaks 2 --refine``: the JAX CLI's lines; the chunk
    values within rtol 2e-2 (the Stein chunks are coarse ranks) and the
    emitter's chunk at (69.25 Hz, 202) in both, the answer (69.25 Hz,
    202) and its value within rtol 1e-4, the lattice rows' dB within 0.05 and the refined
    estimates within 0.01 Hz and 0.01 samples; the bracket line's
    seconds are not compared."""
    needle, capture = map(str, fixture_pairs[0])
    got, want = _both(["stream", needle, capture, "--freq-step", "0.25",
                       "--chunk", "2048", "--backend", backend, "--verbose",
                       "--num-peaks", "2", "--refine"], capsys)
    (g_lines, g_nums), (w_lines, w_nums) = map(_stream_lines, (got, want))
    assert g_lines == w_lines
    for line, g, w in zip(got.splitlines(), g_nums, w_nums):
        if line.startswith("chunk @"):
            # Noise-only chunks rank near-ties: their (freq, lag) may
            # differ; the emitter's chunk may not.
            assert g[0] == w[0]
            assert g[3] == pytest.approx(w[3], rel=2e-2)
            if g[3] > 100:
                assert g[1:3] == w[1:3] == [69.25, 202]
        elif line.startswith(("Peak value", "peak ")) or "efined" in line:
            assert np.allclose(g, w, rtol=1e-4, atol=0.05)
        elif line.startswith("["):
            assert g[:2] + g[3:] == w[:2] + w[3:]
        else:
            assert g == w
    assert "Frequency offset: 69.250 Hz" in got
    assert "Time offset: 202 samples (4.2083 ms)" in got
    assert f"chunk=2048, {backend}]" in got


def test_stream_segment_and_follow_match_jax_cli(fixture_pairs, tmp_path,
                                                 capsys):
    """``stream --segment 1`` of a two-capture SigMF recording (noise,
    then chirp_0's capture) and ``--follow`` of the whole recording with
    a short ``--idle-timeout``: the JAX CLI's answers; ``--follow
    --refine`` skips the refine with the JAX CLI's note."""
    from caf_cookoff_tpu_torch.utils.io import load_c64
    from caf_cookoff_tpu_torch.utils.sigmf import write_sigmf

    needle, capture = map(str, fixture_pairs[0])
    rng = np.random.default_rng(4)
    noise = (0.05 * (rng.standard_normal(3000)
                     + 1j * rng.standard_normal(3000))).astype(np.complex64)
    base = str(tmp_path / "two")
    write_sigmf(base, np.concatenate([noise, load_c64(capture)]), 48_000.0,
                captures=[{"core:sample_start": 0},
                          {"core:sample_start": 3000}])
    common = ["stream", needle, base + ".sigmf-meta", *NARROW, "--chunk",
              "2048"]
    for extra, lag in ((["--segment", "1"], 202),
                       (["--follow", "--idle-timeout", "0.3", "--refine"],
                        3202)):
        got, want = _run_both(common + extra, capsys)
        for prefix in ("Frequency offset:", "Time offset:"):
            assert _lines(got.out, prefix) == _lines(want.out, prefix)
        assert _lines(got.out, "Time offset:")[0].startswith(
            f"Time offset: {lag} samples")
        assert _value(got.out) == pytest.approx(_value(want.out), rel=1e-4)
    note = "--follow discards consumed chunks, so refine is skipped"
    assert note in got.err and note in want.err
    assert "Refined estimate" not in got.out


def test_capture_without_sounddevice_exits_2(tmp_path, capsys):
    """``capture`` needs the optional sounddevice package, absent here:
    both CLIs print the error and exit 2; ``--device`` is the sound
    card's input index, an int."""
    out = str(tmp_path / "cap")
    for main in (jcli.main, tcli.main):
        assert main(["capture", out, "--seconds", "0.1", "--device",
                     "0"]) == 2
        assert "error: live capture needs the optional 'sounddevice'" in \
            capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli.main(["capture", out, "--device", "cuda"])


def test_info_names_the_native_library(capsys, monkeypatch):
    """``info`` ends with the JAX CLI's ``native libcafio:`` line: loaded
    where g++ builds ``native/cafio.cpp``, else the numpy fallback."""
    from caf_cookoff_tpu_torch.utils import native

    assert tcli.main(["info"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        "native libcafio: loaded"
    monkeypatch.setattr(native, "available", lambda: False)
    assert tcli.main(["info"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "native libcafio: absent (numpy fallback")
