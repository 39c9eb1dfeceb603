"""A cell with several emitters a pair, and one with a doppler-rate axis,
are taken from new files alone: in a copy of this folder, a
configuration, a recipe, a workload, an entry and a reference are added
for each, with their rows in a copy of ``BENCHMARK.json``, and a run of
each comes out correct on the CPU while its bfloat16 control fails its
limit, no file of the copy that was there edited.  Neither toy cell is
a cell of the benchmark."""

import hashlib
import json
import shutil
import textwrap

import pytest

from benchmark import calibrate, run, spec
from benchmark.tests import test_benchmark_spec

SEED = 2 ** 31 + 77

TOY = {
    "lattice": {
        "configs/toy2.json": {
            "name": "toy2", "source": "https://example.org/toy2",
            "recipe": "two_emitters", "sample_rate_hz": 48000.0,
            "needle_len": 512, "haystack_len": 512, "lags": 1024,
            "freq_start_hz": -1000.0, "freq_step_hz": 50.0, "bins": 40,
            "reduced": []},
        "workloads/toy2.lattice.json": {
            "name": "toy2.lattice", "config": "toy2", "traffic": "lattice",
            "entry": "toy_lattice", "chips": 1,
            "why": "two emitters a pair, top-2 lattice", "reduced": [],
            "pool": 2, "pairs_per_call": 4, "num_peaks": 2,
            "exclude_freq": 4, "exclude_lag": 2,
            "limits": {"peak_gap": 4e-05}},
        "recipes/two_emitters.py": '''
            """Two emitters a pair: a noise needle, and a haystack of
            the needle delayed and shifted onto two cells of the grid,
            the second 0.7 as strong, in weak noise."""

            import numpy as np


            def make(config, seed, index, pairs):
                n = config["needle_len"]
                fs = float(config["sample_rate_hz"])
                freqs = (config["freq_start_hz"] + config["freq_step_hz"]
                         * np.arange(config["bins"])).astype(np.float32)
                rng = np.random.default_rng([seed % 2 ** 64, 1 + index])
                t = np.arange(n)
                needles = np.empty((pairs, n), np.complex64)
                hays = np.empty((pairs, n), np.complex64)
                truths = []
                for p in range(pairs):
                    needle = (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
                    hay = 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
                    k1 = int(rng.integers(0, 15))
                    k2 = int(rng.integers(25, 40))
                    lag1 = int(rng.integers(0, 100))
                    lag2 = int(rng.integers(150, 250))
                    for amp, k, lag in ((1.0, k1, lag1), (0.7, k2, lag2)):
                        s = amp * needle * np.exp(2j * np.pi * float(freqs[k])
                                                  * t / fs)
                        hay[lag:] += s[:n - lag]
                    needles[p], hays[p] = needle, hay
                    truths.append([(float(freqs[k1]), lag1),
                                   (float(freqs[k2]), lag2)])
                return {"needles": needles, "hays": hays, "truths": truths}
            ''',
        "entries/toy_lattice.py": '''
            """batched_stein_peaks: each pair's two strongest emitters."""

            import torch

            from caf_cookoff_tpu_torch import batched_stein_peaks


            def prepare(cell, item):
                return tuple(torch.from_numpy(item[k]).to(cell.device)
                             for k in ("needles", "hays"))


            def search(cell, prepared, clock):
                w = cell.workload
                return batched_stein_peaks(
                    *prepared, cell.freqs, cell.fs, w["num_peaks"],
                    exclude_freq=w["exclude_freq"],
                    exclude_lag=w["exclude_lag"], device=cell.device)


            def slots(answer):
                return [[(float(f), int(x), float(v)) for f, x, v in zip(*row)]
                        for row in zip(*answer)]


            def pairs(answer):
                return [s[0] for s in slots(answer)]
            ''',
        "reference/toy_lattice.py": '''
            """The greedy exclusion lattice over the full circular
            correlation, its box from the workload's keys."""

            from benchmark.reference import caf


            def lag_range(cell):
                m = int(cell.config["lags"])
                return 0, m, m


            def run(cell, item, probes, precision="float64"):
                lo, hi, m = lag_range(cell)
                w = cell.workload
                box = caf.Box(w["exclude_freq"], w["exclude_lag"], m)
                return caf.peaks(item["needles"], item["hays"], cell.freqs,
                                 cell.fs, m, lo, hi, probes, precision,
                                 cell.device, slots=w["num_peaks"], box=box)
            ''',
    },
    "rate": {
        "configs/toyrate.json": {
            "name": "toyrate", "source": "https://example.org/toyrate",
            "recipe": "swept", "sample_rate_hz": 48000.0,
            "needle_len": 512, "lags": 2048, "freq_start_hz": -1000.0,
            "freq_step_hz": 50.0, "bins": 40,
            "rate_start_hz_per_s": -80000.0,
            "rate_step_hz_per_s": 40000.0, "rates": 5, "reduced": []},
        "workloads/toyrate.rate.json": {
            "name": "toyrate.rate", "config": "toyrate", "traffic": "rate",
            "entry": "toy_rate", "chips": 1,
            "why": "one swept emitter in a capture, 5 rates",
            "reduced": [], "pool": 2, "pairs_per_call": 1,
            "limits": {"peak_gap": 1e-05}},
        "recipes/swept.py": '''
            """One emitter sweeping at a rate of the grid: the needle
            chirped, shifted onto a bin and delayed into a capture of
            unit noise, three times as strong."""

            import numpy as np


            def make(config, seed, index, pairs):
                n, lags = config["needle_len"], config["lags"]
                fs = float(config["sample_rate_hz"])
                rng = np.random.default_rng([seed % 2 ** 64, 1 + index])
                t = np.arange(n) / fs
                needles = np.empty((pairs, n), np.complex64)
                hays = np.empty((pairs, lags + n), np.complex64)
                truths = []
                for p in range(pairs):
                    r = int(rng.integers(0, config["rates"]))
                    k = int(rng.integers(0, config["bins"]))
                    lag = int(rng.integers(0, lags))
                    rate = (config["rate_start_hz_per_s"]
                            + config["rate_step_hz_per_s"] * r)
                    freq = config["freq_start_hz"] + config["freq_step_hz"] * k
                    needle = (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
                    hay = (rng.standard_normal(lags + n)
                           + 1j * rng.standard_normal(lags + n))
                    hay[lag:lag + n] += 3 * needle * np.exp(
                        2j * np.pi * (freq * t + rate / 2 * t * t))
                    needles[p], hays[p] = needle, hay
                    truths.append((rate, freq, lag))
                return {"needles": needles, "hays": hays, "truths": truths}
            ''',
        "entries/toy_rate.py": '''
            """stein_rate_os_peak: (rate, freq, lag, value) a capture."""

            import torch

            from caf_cookoff_tpu_torch import stein_rate_os_peak


            def prepare(cell, item):
                return tuple(torch.from_numpy(item[k][0]).to(cell.device)
                             for k in ("needles", "hays"))


            def search(cell, prepared, clock):
                return stein_rate_os_peak(
                    *prepared, cell.freqs, cell.rates, cell.fs,
                    num_lags=int(cell.config["lags"]), device=cell.device)


            def pairs(answer):
                rate, freq, lag, value = answer
                return [(float(rate), float(freq), int(lag), float(value))]
            ''',
        "reference/toy_rate.py": '''
            """Every rate of the grid: the needle chirped from its first
            sample (window-start frequencies), lags where the needle
            lies wholly inside the capture."""

            import numpy as np

            from benchmark.reference import caf


            def lag_range(cell):
                hay = int(cell.config["lags"]) + int(cell.config["needle_len"])
                return 0, int(cell.config["lags"]), 1 << (hay - 1).bit_length()


            def run(cell, item, probes, precision="float64"):
                lo, hi, m = lag_range(cell)
                t = np.arange(int(cell.config["needle_len"])) / cell.fs
                chirps = np.exp(1j * np.pi * cell.rates.astype(np.float64)[
                    :, None] * t[None, :] ** 2)
                return caf.peaks(item["needles"], item["hays"], cell.freqs,
                                 cell.fs, m, lo, hi, probes, precision,
                                 cell.device, chirps=chirps)
            ''',
    },
}


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).digest()
            for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """A copy of this folder and of ``BENCHMARK.json``, where ``spec``
    finds every piece; every file of the folder's copy is unchanged at
    the end (``BENCHMARK.json`` gains the toy cell's rows)."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    before = _digests(here)
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCHMARK_JSON", tmp_path / "BENCHMARK.json")
    yield here
    after = _digests(here)
    assert {p: d for p, d in after.items() if p in before} == before


def _add(here, kind):
    """The toy cell's files, new in the copy, and its rows in the copy's
    ``BENCHMARK.json``: a configuration, a cell, and the cell in each
    metric's list."""
    files = TOY[kind]
    for rel, body in files.items():
        path = here / rel
        assert not path.exists(), rel
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    config = next(b for r, b in files.items() if r.startswith("configs/"))
    cell = next(b for r, b in files.items() if r.startswith("workloads/"))
    bench = spec.load_benchmark()
    bench["configs"].append({
        "name": config["name"], "source": config["source"],
        "file": f"benchmark/configs/{config['name']}.json",
        "reduced": [], "why": "a toy configuration of the CPU tests"})
    bench["workloads"].append({k: cell[k] for k in (
        "name", "config", "traffic", "chips", "why")})
    for m in bench["per_layer"]:
        m["workloads"].append(cell["name"])
    spec.BENCHMARK_JSON.write_text(json.dumps(bench))
    return cell["name"]


@pytest.mark.parametrize("kind", list(TOY))
def test_cell_from_files_alone(kind, copy):
    name = _add(copy, kind)
    bench = spec.load_benchmark()
    test_benchmark_spec.test_every_piece_found_by_name(bench)
    test_benchmark_spec.test_bounds_and_cells(bench)
    result, info = run.run_cell(name, SEED, 0.5, False, device="cpu")
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {
        m["name"] for m in spec.metrics_for(bench, name, False)}
    port = result["checks"]["peak_gap"]
    ctrl = calibrate.control(name, SEED, "cpu")
    assert ctrl["failed"] > 0
    assert port["value"] < port["limit"] < ctrl["numbers"]["peak_gap"]
