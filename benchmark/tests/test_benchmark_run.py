"""Whole runs on the CPU at small sizes, past the look for a card: a
sound run comes out correct, and a run with its timed path broken
underneath comes out not correct, once for each fault a cell can have."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run, spec
from benchmark.tests.conftest import CELLS, SMALL, SMALL_WORKLOAD

SEED = 2 ** 31 + 4242


def _run(name, small, trace=False, seconds=0.3):
    config, workload = small(name)
    result, info = run.run_cell(name, SEED, seconds, trace, device="cpu",
                                config=config, workload=workload)
    return result, info


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, trace, small):
    result, info = _run(name, small, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == info["searches"] > 0
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.metrics_for(bench, name, trace)}
    if trace:
        # The CPU has no device trace: the device's readers read nothing
        # there but the idle share, ops and syncs (all 100% / 0).
        assert set(result["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert len(result["breakdown"]["idle_gaps"]) >= 1
    else:
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    check = result["checks"]["peak_gap"]
    assert check["value"] <= check["limit"]


def _wrap(monkeypatch, entry, attr, fn):
    module = spec.load_module("entries", entry)
    original = getattr(module, attr)
    monkeypatch.setattr(module, attr, fn(original))


def _lag_off(original):
    """An answer altered where it is produced: every lag one late."""
    def call(*a, **k):
        freq, lag, value = original(*a, **k)
        return freq, lag + 1, value
    return call


ALTER = {"cookoff.single": ("caf_peak_stein", "caf_peak"),
         "widearea.capture": ("batched_stein_os_peak",
                              "batched_stein_os_peak"),
         "cookoff.batch64": ("batched_stein_peak", "batched_stein_peak")}


@pytest.mark.parametrize("name", list(ALTER))
def test_altered_answer_is_not_correct(name, small, monkeypatch):
    _wrap(monkeypatch, *ALTER[name], _lag_off)
    result, _ = _run(name, small)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert result["checks"]["peak_gap"]["value"] > result["checks"][
        "peak_gap"]["limit"]


def test_altered_stream_answer_is_not_correct(small, monkeypatch):
    module = spec.load_module("entries", "streaming_stein")

    class Altered(module.StreamingCAF):
        def best(self):
            freq, lag, value = super().best()
            return freq, lag + 1, value
    monkeypatch.setattr(module, "StreamingCAF", Altered)
    result, _ = _run("widearea.stream", small)
    assert not result["correct"]


def test_stream_step_returning_its_state_is_not_correct(small, monkeypatch):
    """A step that returns its state unchanged: no chunk moves the
    stream, so best() has nothing to answer with."""
    module = spec.load_module("entries", "streaming_stein")

    class Stuck(module.StreamingCAF):
        def process(self, chunk):
            return 0.0, 0, 0.0
    monkeypatch.setattr(module, "StreamingCAF", Stuck)
    result, _ = _run("widearea.stream", small)
    assert not result["correct"]


def _duplicated(original):
    """The second half's answers are the first half's."""
    def call(needles, hays, *a, **k):
        h = needles.shape[0] // 2
        fr, lg, vv = original(needles[:h], hays[:h], *a, **k)
        return (np.concatenate([fr, fr]), np.concatenate([lg, lg]),
                np.concatenate([vv, vv]))
    return call


def _dropped(original):
    """Only the first half's answers come back."""
    def call(needles, hays, *a, **k):
        h = needles.shape[0] // 2
        return original(needles[:h], hays[:h], *a, **k)
    return call


@pytest.mark.parametrize("fault", [_duplicated, _dropped],
                         ids=["duplicated", "dropped"])
def test_half_the_batch_left_out_is_not_correct(fault, small, monkeypatch):
    """Half of the batch left out, its answers filled in from the other
    half or missing."""
    _wrap(monkeypatch, "batched_stein_peak", "batched_stein_peak", fault)
    result, _ = _run("cookoff.batch64", small)
    assert not result["correct"]
    assert result["failed"] == result["attempted"]


def _chunk_relative_lag(module):
    class Relative(module.StreamingCAF):
        def process(self, chunk):
            # The lag counted from the chunk's own first lag.
            base = self._base_lag
            freq, lag, value = super().process(chunk)
            return freq, lag - base, value
    return Relative


def _chunk_dropped(module):
    class Dropped(module.StreamingCAF):
        def process(self, chunk):
            # The stream moves on, but a short chunk's peak is not shown.
            local = super().process(chunk)
            return None if len(chunk) < self._chunk_len else local
    return Dropped


@pytest.mark.parametrize("fault", [_chunk_relative_lag, _chunk_dropped],
                         ids=["relative_lag", "dropped"])
def test_altered_chunk_answer_is_not_correct(fault, small, monkeypatch):
    """A chunk's peak altered where it is produced (its lag from the
    wrong origin), or missing, while best() stays sound."""
    module = spec.load_module("entries", "streaming_stein")
    monkeypatch.setattr(module, "StreamingCAF", fault(module))
    result, info = _run("widearea.stream", small)
    assert not result["correct"]
    assert result["failed"] == result["attempted"]
    checks = result["checks"]
    assert checks["peak_gap"]["value"] <= checks["peak_gap"]["limit"]
    assert checks["chunk_misses"]["value"] > checks["chunk_misses"]["limit"]


def test_stream_reads_its_chunk_gap(small):
    """A sound stream run holds no chunk peak outside its chunk, and
    reads how far its chunk peaks lie from each chunk's true peak."""
    result, info = _run("widearea.stream", small)
    assert result["checks"]["chunk_misses"] == {"value": 0, "limit": 0}
    assert 0 <= info["readings"]["chunk_gap"] < 1


def test_no_jax_after_a_rehearsal():
    """A whole CPU run in a fresh process loads no module whose top-level
    name is jax or caf_cookoff_tpu (compared whole:
    caf_cookoff_tpu_torch begins with the latter)."""
    code = (
        "import json, sys\n"
        "from benchmark import run\n"
        f"res, _ = run.run_cell('cookoff.single', 5, 0.2, True, "
        f"device='cpu', config={SMALL['cookoff']!r}, "
        f"workload={SMALL_WORKLOAD['cookoff.single']!r})\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([res['correct'], run.forbidden_modules(), tops]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert "caf_cookoff_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "caf_cookoff_tpu"} & set(tops)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "caf_cookoff_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "caf_cookoff_tpu.models", sys)
    assert run.forbidden_modules() == ["caf_cookoff_tpu"]


def test_command_without_a_card_prints_no_result():
    """The command needs a card: without one it exits non-zero and
    prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cookoff.single", "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
