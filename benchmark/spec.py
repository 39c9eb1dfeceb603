"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` lies at the root of the checkout, one level above
this folder.  Each configuration, cell, recipe, entry, reference and
metric is a file of its own in this folder, named after it: a later
change adds a piece by adding its file, and edits none that is here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def load_benchmark() -> Dict:
    with open(BENCHMARK_JSON) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json``: a configuration or a cell."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module.  Loaded from its path, so a name
    with a dot in it (a metric such as ``dispatch_ms.serve``) needs no
    package of that name."""
    mod_name = f"benchmark.{kind}.{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def workload_row(bench: Dict, name: str) -> Dict:
    """The cell's entry in ``BENCHMARK.json``."""
    for row in bench["workloads"]:
        if row["name"] == name:
            return row
    raise KeyError(f"no workload named {name!r} in {BENCHMARK_JSON.name}")


def metrics_for(bench: Dict, cell: str, trace: bool):
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    without a trace, its per-layer metrics with one; a metric with a
    ``workloads`` list only in those cells."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]
