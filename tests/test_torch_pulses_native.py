"""The port's ``utils/pulses`` and ``utils/native`` against the JAX
package's: pulse-train artifacts byte for byte, the train found by the
port's engines, and the ctypes binding of ``native/cafio.cpp`` (built
by g++ into ``build/native/``) against numpy and the JAX binding, with
its numpy fallback."""

import numpy as np
import pytest
import torch

from caf_cookoff_tpu.utils import native as jnative
from caf_cookoff_tpu.utils import pulses as jpulses
from caf_cookoff_tpu_torch.utils import native as tnative
from caf_cookoff_tpu_torch.utils import pulses as tpulses

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    {}, dict(pulse_len=256, gap_len=128, num_pulses=4),
    dict(pulse_len=1024, gap_len=0, num_pulses=2, rrc_alpha=0.0,
         tone_freqs_hz=(1000.0, 2000.0, 3000.0))])
def test_pulse_train_matches_jax(kw):
    cfg, jcfg = tpulses.PulseTrainConfig(**kw), jpulses.PulseTrainConfig(**kw)
    assert vars(cfg) == vars(jcfg)
    got = tpulses.generate_pulse_train(cfg)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, jpulses.generate_pulse_train(jcfg))


def test_pulse_artifacts_byte_identical_to_jax(tmp_path):
    """The WAV (stereo float32 I/Q) and the SigMF pair, byte for byte."""
    kw = dict(pulse_len=128, gap_len=64, num_pulses=3)
    x = tpulses.write_pulse_artifacts(tmp_path / "port",
                                      tpulses.PulseTrainConfig(**kw))
    jx = jpulses.write_pulse_artifacts(tmp_path / "jax",
                                       jpulses.PulseTrainConfig(**kw))
    np.testing.assert_array_equal(x, jx)
    for ext in (".wav", ".sigmf-data", ".sigmf-meta"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()
    tpulses.write_pulse_artifacts(tmp_path / "wav_only",
                                  tpulses.PulseTrainConfig(**kw), sigmf=False)
    assert (tmp_path / "wav_only.wav").exists()
    assert not (tmp_path / "wav_only.sigmf-meta").exists()


def test_pulse_train_found_by_the_port():
    """A burst CAF'd against a delayed copy of the train: the delay, by
    the overlap-save scan on a narrow window (as the JAX test searches
    it), and by ``caf_peak`` with a burst-and-gap needle against a
    window that holds the whole delayed burst (a tone's lag is fixed by
    its envelope: the full overlap is the largest)."""
    from caf_cookoff_tpu_torch import caf_peak, overlap_save_peak

    cfg = tpulses.PulseTrainConfig(pulse_len=512, gap_len=256, num_pulses=3)
    train = tpulses.generate_pulse_train(cfg)
    needle, lag = train[:512], 700
    capture = np.concatenate([np.zeros(lag, np.complex64), train])
    freqs = np.zeros(1, dtype=np.float32)
    assert overlap_save_peak(needle, capture[:1500], freqs, cfg.sample_rate,
                             device="cpu")[1] == lag
    freqs = np.arange(-200.0, 200.0, 25.0, dtype=np.float32)
    f, got_lag, _ = caf_peak(train[:768], capture[650:650 + 768], freqs,
                             cfg.sample_rate, device="cpu")
    assert (f, got_lag) == (0.0, lag - 650)


def _rand_c64(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.fixture
def no_lib(monkeypatch):
    """The port's binding with the library unavailable."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_attempted", True)


def _binding_round(tmp_path, tag):
    x = _rand_c64(4096 + 33, seed=1)
    path = tmp_path / f"{tag}.c64"
    x.tofile(path)
    out = {"samples": tnative.file_samples(path),
           "split": tnative.load_c64_split(path),
           "part": tnative.load_c64_split(path, count=100, offset=37),
           "eof": tnative.load_c64_split(path, count=10_000, offset=4100),
           "planes": tnative.deinterleave(x)}
    tnative.write_c64_split(tmp_path / f"{tag}_w.c64", x.real, x.imag)
    tnative.write_f64(tmp_path / f"{tag}.f64",
                      np.arange(800.0).reshape(20, 40))
    return x, out


def _check_binding(tmp_path, tag):
    x, out = _binding_round(tmp_path, tag)
    assert out["samples"] == len(x)
    np.testing.assert_array_equal(out["split"][0], x.real)
    np.testing.assert_array_equal(out["split"][1], x.imag)
    np.testing.assert_array_equal(out["part"][0], x.real[37:137])
    assert len(out["eof"][0]) == 29
    for got, want in zip(out["planes"], (x.real, x.imag)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / f"{tag}_w.c64", dtype="<c8"), x)
    assert (tmp_path / f"{tag}.f64").read_bytes() == \
        np.arange(800.0).astype("<f8").tobytes()
    return out


def test_native_binding_matches_numpy_and_jax(tmp_path):
    """Built by g++ into build/native/ (never native/), loaded, and equal
    to numpy and to the JAX package's binding, files byte for byte."""
    assert tnative.available()
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    _check_binding(tmp_path, "port")
    if jnative.available():
        x = _rand_c64(1 << 12, seed=2)
        for got, want in zip(tnative.deinterleave(x), jnative.deinterleave(x)):
            np.testing.assert_array_equal(got, want)
        jnative.write_c64_split(tmp_path / "jax_w.c64", x.real, x.imag)
        tnative.write_c64_split(tmp_path / "port_w2.c64", x.real, x.imag)
        assert (tmp_path / "jax_w.c64").read_bytes() == \
            (tmp_path / "port_w2.c64").read_bytes()
    with pytest.raises(OSError):
        tnative.load_c64_split(tmp_path / "missing.c64")


def test_native_threaded_deinterleave():
    """Above libcafio's threading threshold (1 << 20 samples)."""
    x = _rand_c64((1 << 20) + 17, seed=4)
    re, im = tnative.deinterleave(x)
    np.testing.assert_array_equal(re, x.real)
    np.testing.assert_array_equal(im, x.imag)


def test_native_numpy_fallback(tmp_path, no_lib):
    assert not tnative.available()
    _check_binding(tmp_path, "fallback")


def test_native_build_failure_falls_back(tmp_path, monkeypatch):
    """No compiler: ``build_native`` reports False and nothing is
    written; the binding then answers from numpy."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert tnative.build_native() is False
    assert not (tmp_path / "build").exists()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_attempted", False)
    assert tnative.get_lib() is None
    x = _rand_c64(64, seed=5)
    np.testing.assert_array_equal(tnative.deinterleave(x)[0], x.real)
