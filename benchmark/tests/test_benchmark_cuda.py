"""On the card: one short run of each cell through the command, its
last line as the contract has it.  Run there with
``python -m pytest benchmark/tests/test_benchmark_cuda.py -m cuda``."""

import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_one_run_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace",
         str(trace)], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks" and result["correct"]
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.metrics_for(bench, name, bool(trace))}
    assert set(result["metrics"]) == want
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        share = result["metrics"]["kernel_roofline_share"]["value"]
        assert 0 < share <= 100
    # The last lines of standard error: each number compared, in the
    # order of the result's checks.
    checks = result["checks"]
    tail = out.stderr.strip().splitlines()[-len(checks):]
    assert [line.split()[:2] for line in tail] == [["check", k]
                                                   for k in checks]
