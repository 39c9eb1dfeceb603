"""The port's import layers, read from its source with ``ast``.

``ops/`` <- ``models/_stein_plan`` <- the Stein engines (``stein``,
``batched_stein``, ``streaming``, ``rate``) <- ``parallel/``: no module
imports from a layer above its own, the engines and ``parallel/`` import
what they use at module top, and the route each Stein engine takes is
defined once.
"""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "caf_cookoff_tpu_torch"
NAME = "caf_cookoff_tpu_torch"
ENGINES = ("stein", "batched_stein", "streaming", "rate")
PARALLEL = sorted(p.stem for p in (PKG / "parallel").glob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _imported(node) -> list:
    """The dotted module names an import statement reads from."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [node.module] + [f"{node.module}.{a.name}"
                                for a in node.names]
    return []


def _imports(path: pathlib.Path, in_functions: bool = False) -> list:
    """Every module name ``path`` imports (with ``in_functions``: only
    those imported inside a function body)."""
    tree = _tree(path)
    if not in_functions:
        return [m for node in ast.walk(tree) for m in _imported(node)]
    return [m for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for node in ast.walk(fn) for m in _imported(node)]


def _under(modules, *layers) -> list:
    return sorted({m for m in modules
                   if any(m == f"{NAME}.{layer}"
                          or m.startswith(f"{NAME}.{layer}.")
                          for layer in layers)})


@pytest.mark.parametrize("layer,above", [("ops", ("models", "parallel")),
                                         ("models", ("parallel",))])
def test_no_module_imports_from_a_layer_above(layer, above):
    bad = {p.name: _under(_imports(p), *above)
           for p in sorted((PKG / layer).glob("*.py"))}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize("path", [f"models/{m}.py" for m in ENGINES]
                         + [f"parallel/{m}.py" for m in PARALLEL])
def test_engines_and_parallel_import_at_module_top(path):
    """No function body of a Stein engine imports a models module, and
    none in ``parallel/`` a models or ops module."""
    layers = ("models",) if path.startswith("models/") else ("models",
                                                            "ops")
    assert _under(_imports(PKG / path, in_functions=True), *layers) == []


@pytest.mark.parametrize("name", ["_band_routing", "_windowed_route"])
def test_the_route_is_defined_once(name):
    where = [str(p.relative_to(PKG)) for p in sorted(PKG.rglob("*.py"))
             for node in ast.walk(_tree(p))
             if isinstance(node, ast.FunctionDef) and node.name == name]
    assert where == ["models/_stein_plan.py"]
