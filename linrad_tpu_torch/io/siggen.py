"""Deterministic synthetic IQ generator — the test/validation backend.

Equivalent of Linrad's internal generator (reference rxin.c:43-190):
a strong carrier at relative frequency IG_CF1=0.03, a keyed -60 dB
sideband at IG_CF2=0.04 with an ~0.8 ms keying period scale
(KEY_COUNT = fs*0.0008), and optional Gaussian noise from
``lir_noisegen`` (reference lxsys.c:449-460:
sin(2*pi*z)*sqrt(-2*ln y)*2^(level/2)).

This host-side generator is numpy-based and fully deterministic (seeded),
serving the same role as the reference's INTERNAL_GEN_ADD_AGCTEST path:
end-to-end validation without hardware.  It additionally supports
arbitrary user-specified tones, keyed CW signals, and impulse noise
bursts for blanker tests (the reference validates blankers on real
recordings; we need reproducible synthetic pulses).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

IG_CF1 = 0.03   # rad/sample — strong carrier (rxin.c:50)
IG_CF2 = 0.04   # rad/sample — keyed weak sideband (rxin.c:51)


@dataclass
class Tone:
    freq_hz: float
    amplitude: float = 1.0
    phase: float = 0.0
    # optional on/off keying: period in seconds, duty in [0,1]
    key_period_s: float = 0.0
    key_duty: float = 1.0


def tones_iq(fs: float, n: int, tones: list[Tone], start: int = 0,
             dtype=np.complex64) -> np.ndarray:
    """Sum of (optionally keyed) complex tones, phase-continuous in the
    absolute sample index ``start`` so streamed blocks join seamlessly."""
    t = (start + np.arange(n, dtype=np.float64))
    out = np.zeros(n, np.complex128)
    for tone in tones:
        ph = 2.0 * np.pi * tone.freq_hz / fs * t + tone.phase
        sig = tone.amplitude * np.exp(1j * ph)
        if tone.key_period_s > 0:
            period = tone.key_period_s * fs
            frac = np.mod(t, period) / period
            sig = np.where(frac < tone.key_duty, sig, 0.0)
        out += sig
    return out.astype(dtype)


def gaussian_noise(rng: np.random.Generator, n: int, level_bits: float,
                   complex_out: bool = True) -> np.ndarray:
    """lir_noisegen semantics: sigma = 2^(level/2) per real component
    (reference lxsys.c:449-460)."""
    sigma = 2.0 ** (0.5 * level_bits)
    if complex_out:
        return (rng.normal(0, sigma, n) + 1j * rng.normal(0, sigma, n)
                ).astype(np.complex64)
    return rng.normal(0, sigma, n).astype(np.float32)


def impulse_noise(rng: np.random.Generator, n: int, rate_hz: float,
                  fs: float, amplitude: float, width: int = 1) -> np.ndarray:
    """Static-crash style impulse train for blanker validation: random
    sample positions, random phase, optional width-sample pulses."""
    out = np.zeros(n, np.complex64)
    count = rng.poisson(rate_hz * n / fs)
    pos = rng.integers(0, max(n - width, 1), size=count)
    for p in pos:
        phase = rng.uniform(0, 2 * np.pi)
        shape = np.hanning(width + 2)[1:-1] if width > 1 else np.ones(1)
        out[p: p + width] += (amplitude * np.exp(1j * phase)
                              * shape[: n - p]).astype(np.complex64)
    return out


@dataclass
class InternalGenerator:
    """Streaming generator matching rxin.c:43-190 signal structure.

    Produces float IQ in 16-bit-like units (carrier amplitude 0x7e00) with
    the keyed -60 dB sideband and optional Gaussian noise.  ``channels=2``
    duplicates the signal into both polarization channels exactly as the
    reference does (rxin.c:93-106).
    """

    fs: float
    channels: int = 1
    noise_level_bits: int = 0   # 0 = off; else lir_noisegen(level-1)
    seed: int = 1234
    sample_index: int = 0
    _rng: np.random.Generator = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, n: int) -> np.ndarray:
        """Return (n, channels) complex64."""
        idx = self.sample_index + np.arange(n, dtype=np.float64)
        key_count = self.fs * 0.0008
        carrier = 0x7E00 * np.exp(1j * IG_CF1 * idx)
        keyphase = np.mod(idx, key_count + 1)
        keyed = np.where(keyphase < key_count / 4,
                         0x7E00 * 0.001 * np.exp(1j * IG_CF2 * idx), 0.0)
        sig = carrier + keyed
        if self.noise_level_bits:
            sig = sig + gaussian_noise(self._rng, n,
                                       self.noise_level_bits - 1)
        self.sample_index += n
        out = np.repeat(sig[:, None], self.channels, axis=1)
        return out.astype(np.complex64)
