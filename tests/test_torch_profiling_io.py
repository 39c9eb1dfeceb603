"""The port's ``utils/profiling`` and ``utils/io`` against the JAX
package's: the run report's lines and JSON, the peak-to-floor ratio,
``report_run``, ``Stopwatch``, the ``torch.profiler`` trace, and the
file helpers byte for byte."""

import json

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.utils import io as jio
from caf_cookoff_tpu.utils import profiling as jprof
from caf_cookoff_tpu_torch.utils import io as tio
from caf_cookoff_tpu_torch.utils import profiling as tprof

# Private fixture copies: the shared data/ may be rewritten by another
# worker while this module reads it (see test_torch_fixtures.py).
from test_torch_fixtures import chirp, fixture_pairs  # noqa: E402,F401

torch.set_num_threads(1)

REPORTS = [
    dict(freq_hz=69.25, lag_samples=202, peak_value=902.92, sample_rate=48e3,
         num_doppler_bins=800, xcor_len=8192),
    dict(freq_hz=-76.25, lag_samples=-151, peak_value=1.5e6, sample_rate=96e3,
         num_doppler_bins=24, xcor_len=8192, elapsed_ms=0.4213,
         peak_to_floor_db=41.23, backend="stein"),
    dict(freq_hz=0.0, lag_samples=0, peak_value=0.0, sample_rate=48e3,
         num_doppler_bins=1, xcor_len=2, elapsed_ms=2.5,
         peak_to_floor_db=float("inf"), backend=None),
]


@pytest.mark.parametrize("fields", REPORTS)
def test_run_report_matches_jax(fields):
    got, want = tprof.RunReport(**fields), jprof.RunReport(**fields)
    assert got.result_lines() == want.result_lines()
    assert got.to_json() == want.to_json()
    assert got.lag_ms == want.lag_ms
    assert got.surfaces_per_second == want.surfaces_per_second


@pytest.mark.parametrize("shape,floor", [((4, 8), 1.0), ((3, 5), 2.0),
                                         ((2, 6), 0.0), ((2, 3), -1.0)])
def test_peak_to_floor_matches_jax(shape, floor):
    """``np.median`` on the host in both (the even-count median is the
    mean of the two middle values); a floor at or below 0 gives +inf."""
    rng = np.random.default_rng(shape[0])
    surf = floor + 0.1 * np.abs(rng.standard_normal(shape))
    if floor <= 0:
        surf[:] = floor
    surf[0, 0] = 1000.0
    got = tprof.peak_to_floor_db(surf, 1000.0)
    assert got == jprof.peak_to_floor_db(surf, 1000.0)
    if floor <= 0:
        assert got == float("inf")
    # A tensor on the CPU reads the same.
    assert tprof.peak_to_floor_db(torch.from_numpy(surf), 1000.0) == got


def test_report_run_matches_jax(chirp):
    from caf_cookoff_tpu_torch.models.filterbank import caf_surface

    needle, haystack, _ = chirp(0)
    freqs = np.arange(60, 80, 0.25, dtype=np.float32)
    surface = caf_surface(needle, haystack, freqs, 48e3,
                          device="cpu").numpy()
    got = tprof.report_run(surface, freqs, 48e3, elapsed_ms=0.5,
                           backend="xla")
    want = jprof.report_run(surface, freqs, 48e3, elapsed_ms=0.5,
                            backend="xla")
    assert got == tprof.RunReport(**vars(want))
    assert (got.freq_hz, got.lag_samples) == (69.25, 202)
    assert got.peak_to_floor_db > 20
    assert got.result_lines() == want.result_lines()


def test_stopwatch():
    with tprof.Stopwatch() as sw:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert sw.ms is not None and sw.ms >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)):
        torch.fft.fft(torch.ones(1024, dtype=torch.complex64))
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_trace_degrades_to_a_note(tmp_path, capsys, monkeypatch):
    """A profiler that cannot start leaves the block untraced, with a
    note, as the JAX package's ``trace`` does."""
    import torch.profiler as tp

    def refuse(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(tp.profile, "__enter__", refuse)
    with tprof.trace(str(tmp_path / "none")):
        pass
    assert "profiler unavailable (profiler busy)" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


def _rand_c64(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("writer,data", [
    ("write_c64", _rand_c64(257, 0)),
    ("write_c128", _rand_c64(129, 1).astype(np.complex128)),
    ("write_c128", _rand_c64(33, 2)),
    ("dump_surf", np.arange(800.0, dtype=np.float32).reshape(20, 40)),
    ("save_npy", np.arange(60.0).reshape(3, 20)),
    ("save_npy", _rand_c64(17, 3))])
def test_io_writers_byte_identical_to_jax(tmp_path, writer, data):
    for mod, name in ((jio, "jax"), (tio, "port")):
        getattr(mod, writer)(tmp_path / f"{name}.npy", data)
    assert (tmp_path / "port.npy").read_bytes() == \
        (tmp_path / "jax.npy").read_bytes()


def test_io_readers_match_jax(tmp_path):
    x = np.linspace(-1, 1, 101, dtype=np.float32)
    x.astype("<f4").tofile(tmp_path / "x.f32")
    for count in (None, 7):
        got = tio.load_f32(tmp_path / "x.f32", count)
        want = jio.load_f32(tmp_path / "x.f32", count)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    surf = np.arange(60.0).reshape(3, 20)
    tio.dump_surf(tmp_path / "s.f64", surf)
    np.testing.assert_array_equal(tio.load_surf(tmp_path / "s.f64", 3),
                                  jio.load_surf(tmp_path / "s.f64", 3))
    c = _rand_c64(9, 4)
    for fn in ("c64_to_c128", "f32_to_c128"):
        arg = c if fn == "c64_to_c128" else x
        got, want = getattr(tio, fn)(arg), getattr(jio, fn)(arg)
        assert got.dtype == want.dtype == np.complex128
        np.testing.assert_array_equal(got, want)
