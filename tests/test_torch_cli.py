"""The port's CLI verbs and bench harness against the JAX package's, on
the CPU (``--device cpu``: the port runs on the card unless asked)."""

import json
import pathlib
import re

import pytest
import torch

from caf_cookoff_tpu import cli as jcli
from caf_cookoff_tpu.utils import bench as jbench
from caf_cookoff_tpu_torch import cli as tcli
from caf_cookoff_tpu_torch.utils import bench as tbench

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
    needle, haystack = map(str, fixture_pairs[0])
    for argv, item in (
            (["run", needle, haystack, "--num-peaks", "2", "--refine"],
             "item 11"),
            (["run", needle, haystack, "--full-haystack",
              "--rate-grid=-300:300:150"], "item 12"),
            (["batch", f"{needle}:{haystack}", "--num-peaks", "3",
              "--refine"], "item 11")):
        assert tcli.main(argv + ["--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert "not ported yet" in err and item in err


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
