"""Pulsed-tone test-signal synthesis — the ``grc/generate.grc`` analog (a
copy of the JAX package's ``utils/pulses.py``; the artifacts written are
byte-identical).

The reference's second data path is a GNU Radio flowgraph ("Generate
Pulses", ``grc/generate.grc``) that interleaves two tone bursts through a
patterned interleaver, shapes them with a root-raised-cosine envelope
(alpha = 0.35 taps variable, grc line ~38), and records WAV + SigMF at
fs = 48 kHz for real-world CAF exercises.  This module synthesizes the
same kind of signal directly — alternating shaped tone pulses with
silence gaps — and writes the same artifact pair (WAV via scipy, SigMF
via :mod:`caf_cookoff_tpu_torch.utils.sigmf`), so the capture-and-CAF workflow
works without GNU Radio.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from caf_cookoff_tpu_torch.utils.io import PathLike


@dataclasses.dataclass(frozen=True)
class PulseTrainConfig:
    """Alternating-tone pulse train parameters (generate.grc defaults)."""

    sample_rate: float = 48_000.0
    tone_freqs_hz: Tuple[float, ...] = (1_000.0, 2_000.0)
    pulse_len: int = 4_096          # samples per burst
    gap_len: int = 4_096            # silence between bursts
    num_pulses: int = 8
    rrc_alpha: float = 0.35         # RRC roll-off (grc taps variable)
    amplitude: float = 0.7


def _raised_cosine_envelope(n: int, alpha: float) -> np.ndarray:
    """Smooth burst envelope: flat top with raised-cosine ramps.

    The flowgraph shapes bursts through an RRC filter; for synthesis we
    apply the equivalent time-domain effect (band-limited edges) with
    ramps covering ``alpha/2`` of the pulse on each side.
    """
    ramp = max(1, int(n * alpha / 2))
    env = np.ones(n)
    t = 0.5 * (1 - np.cos(np.pi * np.arange(ramp) / ramp))
    env[:ramp] = t
    env[-ramp:] = t[::-1]
    return env


def generate_pulse_train(config: PulseTrainConfig = PulseTrainConfig()
                         ) -> np.ndarray:
    """Complex64 pulse train: tones alternating per the interleaver."""
    env = _raised_cosine_envelope(config.pulse_len, config.rrc_alpha)
    n_idx = np.arange(config.pulse_len)
    segments = []
    for p in range(config.num_pulses):
        f = config.tone_freqs_hz[p % len(config.tone_freqs_hz)]
        tone = np.exp(2j * np.pi * f * n_idx / config.sample_rate)
        segments.append((config.amplitude * env * tone))
        segments.append(np.zeros(config.gap_len))
    return np.concatenate(segments).astype(np.complex64)


def write_pulse_artifacts(base_path: PathLike,
                          config: PulseTrainConfig = PulseTrainConfig(),
                          *, wav: bool = True,
                          sigmf: bool = True) -> np.ndarray:
    """Synthesize and record WAV + SigMF like the flowgraph's sinks.

    WAV carries I/Q as a stereo float32 file (the ``blocks_wavfile_sink``
    convention); SigMF is the primary machine-readable artifact.
    Returns the samples.
    """
    import os

    samples = generate_pulse_train(config)
    base = os.fspath(base_path)
    if wav:
        from scipy.io import wavfile

        stereo = np.stack([samples.real, samples.imag], axis=1)
        wavfile.write(base + ".wav", int(config.sample_rate),
                      stereo.astype(np.float32))
    if sigmf:
        from caf_cookoff_tpu_torch.utils.sigmf import write_sigmf

        write_sigmf(base, samples, config.sample_rate,
                    description="pulsed tones (generate.grc analog)",
                    extra_global={"caf:tone_freqs_hz":
                                  list(config.tone_freqs_hz)})
    return samples
