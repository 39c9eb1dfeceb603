"""The port's CLI verbs and bench harness against the JAX package's, on
the CPU (``--device cpu``: the port runs on the card unless asked)."""

import pathlib

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
