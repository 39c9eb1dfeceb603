"""BENCHMARK.json keeps to the benchmark's contract, and every piece a
cell needs is found by its name."""

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not any(
        c in text for c in "\n\r\t")


def test_top_level(bench):
    assert set(bench) == KEYS
    assert spec.BENCHMARK_JSON.stat().st_size <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (spec.ROOT / p).is_dir()


def test_names_and_units(bench):
    rows = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
            + bench["per_layer"])
    for row in rows:
        assert NAME.match(row["name"]), row["name"]
    for kind in ("configs", "workloads"):
        names = [r["name"] for r in bench[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_entry_keys(bench):
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in bench["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in bench["end_to_end"])
    layer = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == layer for m in bench["per_layer"])


def test_bounds_and_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        reported = spec.metrics_for(bench, w["name"], False)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_for(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", []):
            row = e2e[m["moves"]]
            assert cell in row.get("workloads", [cell])


def test_every_per_layer_metric_lists_its_cells(bench):
    """A per-layer metric without a list is owed by every cell that
    reports what it moves, later cells too; each names its cells, and
    each of them reports the metric it moves."""
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m.get("workloads"), m["name"]
        assert set(m["workloads"]) <= cells
        assert len(m["workloads"]) == len(set(m["workloads"]))
        for cell in m["workloads"]:
            reported = spec.metrics_for(bench, cell, False)
            assert m["moves"] in {r["name"] for r in reported}, (
                m["name"], cell)


def test_every_piece_found_by_name(bench):
    by_config = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.load_json("workloads", w["name"])
        for k in ("name", "config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        assert cell["reduced"] == []
        config = spec.load_json("configs", w["config"])
        row = by_config[w["config"]]
        assert row["file"] == f"benchmark/configs/{w['config']}.json"
        assert config["name"] == row["name"]
        assert config["reduced"] == row["reduced"] == []
        assert config["source"] == row["source"]
        spec.load_module("recipes", config["recipe"])
        entry, _ = (spec.load_module(kind, cell["entry"])
                    for kind in ("entries", "reference"))
        chunked = {"chunk_misses"} if hasattr(entry, "chunks") else set()
        assert set(cell["limits"]) == {"peak_gap"} | chunked
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_configuration_files_differ(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in bench["paths"]))
        json.loads((spec.ROOT / f).read_text())
