"""Port's config, errors, fixture I/O and conversion helpers against the
JAX package, plus the port's import boundary (no JAX inside it)."""

import pathlib
import re

import numpy as np
import pytest
import torch

import caf_cookoff_tpu.config as jcfg
import caf_cookoff_tpu.errors as jerr
from caf_cookoff_tpu.utils import generate as jgen
from caf_cookoff_tpu.utils import io as jio
import caf_cookoff_tpu_torch.config as tcfg
import caf_cookoff_tpu_torch.errors as terr
from caf_cookoff_tpu_torch.models.filterbank import (FilterbankCAF, caf_peak,
                                                     caf_surface)
from caf_cookoff_tpu_torch.utils import generate as tgen
from caf_cookoff_tpu_torch.utils import io as tio
from caf_cookoff_tpu_torch.utils.convert import (as_signal,
                                                 caf_config_from_jax,
                                                 split_to_complex)

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

PORT_DIR = pathlib.Path(__file__).resolve().parents[1] / "caf_cookoff_tpu_torch"

GRIDS = [(-100.0, 100.0, 0.5), (-100.0, 100.0, 0.25), (-50.0, 50.0, 1.0),
         (30.0, 35.0, 0.05), (80.0, 100.0, 0.1), (-0.3, 0.7, 0.001),
         (10.0, 10.5, 0.3)]


@pytest.mark.parametrize("start,stop,step", GRIDS)
def test_freq_grid_matches_jax(start, stop, step):
    jg = jcfg.FreqGrid(start, stop, step)
    tg = tcfg.FreqGrid(start, stop, step)
    assert tg.num_bins == jg.num_bins
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(tg.frequencies(dtype),
                                      jg.frequencies(dtype))
    assert caf_config_from_jax(jg) == tg
    np.testing.assert_array_equal(
        tcfg.as_grid(tg.frequencies()), jcfg.as_grid(jg.frequencies()))


@pytest.mark.parametrize("n", [1, 2, 3, 100, 128, 4096, 5000])
def test_length_helpers_match_jax(n):
    assert tcfg.xcor_length(n) == jcfg.xcor_length(n)
    assert tcfg.next_pow2(n) == jcfg.next_pow2(n)
    assert tcfg.is_pow2(n) == jcfg.is_pow2(n)
    assert tcfg.floor_pow2(n) == jcfg.floor_pow2(n)
    if jcfg.is_pow2(n):
        assert tcfg.log2_int(n) == jcfg.log2_int(n)
    else:
        with pytest.raises(ValueError):
            tcfg.log2_int(n)


def test_config_validation_matches_jax(monkeypatch):
    for bad in [dict(precision="c32"), dict(backend="cufft")]:
        with pytest.raises(ValueError):
            jcfg.CafConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.CafConfig(**bad)
    for backend in ("auto", "xla", "matmul", "matmul-highest", "matmul-high",
                    "matmul-bf16", "pallas", "pallas-refine", "pallas-bf16",
                    "stein", "stein-raw"):
        jc = jcfg.CafConfig(backend=backend, precision="c128")
        tc = caf_config_from_jax(jc)
        assert tc == tcfg.CafConfig(backend=backend, precision="c128")
        assert tc.complex_dtype == jc.complex_dtype
        assert tc.real_dtype == jc.real_dtype
    assert tcfg.BENCH_GRID == caf_config_from_jax(jcfg.BENCH_GRID)
    for bad_grid in [(1.0, 1.0, 0.5), (0.0, 1.0, 0.0)]:
        with pytest.raises(ValueError):
            tcfg.FreqGrid(*bad_grid)
    for bad in ([], [[1.0]], [0.0, np.nan]):
        with pytest.raises(ValueError):
            jcfg.as_grid(bad)
        with pytest.raises(ValueError):
            tcfg.as_grid(bad)
    # The card by default; without one, an error that names device="cpu"
    # (never a silent CPU run); device="cpu" on request.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcfg.default_device()
    needle = np.exp(0.3j * np.arange(16)).astype(np.complex64)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        caf_peak(needle, needle, [0.0, 10.0], 48e3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        caf_surface(needle, needle, [0.0, 10.0], 48e3, backend="pallas")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FilterbankCAF(tcfg.CafConfig(grid=tcfg.FreqGrid(-10.0, 10.0, 5.0))
                      ).peak(needle, needle)
    assert caf_peak(needle, needle, [0.0, 10.0], 48e3,
                    device="cpu")[:2] == (0.0, 0)
    assert FilterbankCAF(tcfg.CafConfig(grid=tcfg.FreqGrid(-10.0, 10.0, 5.0)),
                         device="cpu").peak(needle, needle) == (0.0, 0)


def test_error_hierarchy_matches_jax():
    for name in ("EngineError", "SpanError", "EligibilityError",
                 "VmemBudgetError"):
        tcls, jcls = getattr(terr, name), getattr(jerr, name)
        assert [c.__name__ for c in tcls.__mro__] == \
            [c.__name__ for c in jcls.__mro__]
        assert issubclass(tcls, ValueError)


def test_generators_byte_identical(tmp_path):
    jpairs = jgen.synthesize_fixtures(tmp_path / "jax")
    tpairs = tgen.synthesize_fixtures(tmp_path / "torch")
    assert [tuple(map(lambda p: pathlib.Path(p).name, pr)) for pr in jpairs] \
        == [tuple(map(lambda p: pathlib.Path(p).name, pr)) for pr in tpairs]
    for jp, tp in zip(jpairs, tpairs):
        for a, b in zip(jp, tp):
            assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    # ensure_fixtures finds the existing files instead of regenerating.
    assert tgen.ensure_fixtures(tmp_path / "torch") == tpairs


def test_ground_truth_and_loaders_match_jax(tmp_path, fixture_pairs):
    for needle_path, hay_path in fixture_pairs:
        assert tio.parse_ground_truth(hay_path) == \
            tuple(jio.parse_ground_truth(hay_path))
        np.testing.assert_array_equal(tio.load_c64(needle_path),
                                      jio.load_c64(needle_path))
        np.testing.assert_array_equal(tio.load_c64(hay_path, count=100),
                                      jio.load_c64(hay_path, count=100))
    with pytest.raises(ValueError):
        tio.parse_ground_truth("chirp_raw.c64")
    x = (np.arange(8) + 1j * np.arange(8)[::-1]).astype(np.complex128)
    tio.write_c64(tmp_path / "t.c64", x)
    jio.write_c64(tmp_path / "j.c64", x)
    assert (tmp_path / "t.c64").read_bytes() == (tmp_path / "j.c64").read_bytes()


def test_convert_helpers():
    rng = np.random.default_rng(0)
    re, im = rng.standard_normal((2, 16)).astype(np.float32)
    c = split_to_complex(re, im, device="cpu")
    assert c.dtype == torch.complex64
    np.testing.assert_array_equal(c.numpy(), re + 1j * im)
    c128 = split_to_complex(re.astype(np.float64), im.astype(np.float64),
                            device="cpu")
    assert c128.dtype == torch.complex128
    real = as_signal(re, device="cpu")
    assert real.dtype == torch.complex64
    np.testing.assert_array_equal(real.numpy().imag, 0)
    with pytest.raises(ValueError):
        as_signal(np.zeros(0, np.complex64), device="cpu")


def test_port_imports_no_jax():
    """The port package never imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"(from|import)\s+caf_cookoff_tpu(\.|\s|$))", re.M)
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 15
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_and_new_modules_import_no_jax():
    """``chip_smoke.py`` imports neither jax nor the JAX package, and the
    modules of the streaming slice are among the files checked above."""
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"(from|import)\s+caf_cookoff_tpu(\.|\s|$))", re.M)
    smoke = PORT_DIR.parent / "chip_smoke.py"
    assert not pat.search(smoke.read_text())
    names = {f.relative_to(PORT_DIR).as_posix()
             for f in PORT_DIR.rglob("*.py")}
    assert {"models/streaming.py", "utils/profiling.py", "utils/pulses.py",
            "utils/native.py"} <= names


@pytest.mark.parametrize("sub", ["models", "ops", "utils"])
def test_subpackage_names_match_jax(sub):
    """Each subpackage re-exports the JAX package's names: the same
    ``__all__``, and each name the port's function or class, not a
    submodule (``caf_cookoff_tpu_torch.ops.xcor`` is the function, as in
    JAX)."""
    import importlib
    import types

    jmod = importlib.import_module(f"caf_cookoff_tpu.{sub}")
    tmod = importlib.import_module(f"caf_cookoff_tpu_torch.{sub}")
    assert tmod.__all__ == jmod.__all__
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        assert not isinstance(obj, types.ModuleType), name
        assert obj.__module__.startswith("caf_cookoff_tpu_torch."), name
        assert callable(obj), name


@pytest.mark.parametrize("start,stop,step", GRIDS)
@pytest.mark.parametrize("multiple", [1, 8, 16, 48])
def test_freq_grid_padded_matches_jax(start, stop, step, multiple):
    jg, jn = jcfg.FreqGrid(start, stop, step).padded(multiple)
    tg, tn = tcfg.FreqGrid(start, stop, step).padded(multiple)
    assert tn == jn and tg.num_bins == jg.num_bins
    assert tg.num_bins % multiple == 0
    assert caf_config_from_jax(jg) == tg
    np.testing.assert_array_equal(tg.frequencies(np.float32),
                                  jg.frequencies(np.float32))
