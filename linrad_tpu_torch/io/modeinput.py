"""Seeded test inputs that fit each Linrad receive mode.

An operator picks a mode (``params.preset``) for a kind of signal, and a
mode is only exercised by its own kind: a keyed CW tone near the noise
with impulse noise and a strong neighbour for the CW modes (the blankers
fit the impulses, sellim limits the neighbour, the AFC finds the tone), a
keyed tone in a 3 kHz passband beside a strong out-of-band carrier for
SSB, short bursts for meteor scatter, a modulated carrier for AM and FM,
and a pulse train with its echo for radar.  Each maker returns complex64
IQ of shape (steps * samples_per_step, channels) for a receiver tuned to
``dial_hz``; the same seed gives the same samples.
"""

from __future__ import annotations

import numpy as np

from ..geometry import Geometry
from ..params import RxMode
from ..tx.keying import radar_pulse_train

CARRIER_HZ = -21_000.0      # the strong neighbour, far outside every passband


def _time(geo: Geometry, steps: int) -> np.ndarray:
    return np.arange(steps * geo.samples_per_step) / geo.timf1_sampling_speed


def _noise(rng, n: int, sigma: float) -> np.ndarray:
    return sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))


def _impulses(rng, x: np.ndarray, geo: Geometry, steps: int, count: int,
              amplitude: float) -> None:
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, count)
        x[pos] += amplitude * np.exp(2j * np.pi * rng.uniform(size=count))


def _keyed(t: np.ndarray, period_s: float, duty: float) -> np.ndarray:
    return ((t / period_s) % 1.0 < duty).astype(np.float64)


def weak_cw(geo: Geometry, steps: int, dial_hz: float, *, seed: int = 1,
            offset_hz: float = 40.0, amplitude: float = 3.0,
            key_period_s: float = 0.24, sigma: float = 10.0,
            impulses: int = 40) -> np.ndarray:
    """A keyed tone ``offset_hz`` above the dial, near the noise in a 3 kHz
    band (amplitude 3 in noise of sigma 10 per component at the A/D rate),
    ``impulses`` impulses of 3000 per step and a carrier of 2000 at
    CARRIER_HZ, which sellim limits (NCW, WCW, QRSS)."""
    rng = np.random.default_rng(seed)
    t = _time(geo, steps)
    x = (amplitude * _keyed(t, key_period_s, 0.75)
         * np.exp(2j * np.pi * (dial_hz + offset_hz) * t))
    x = x + _noise(rng, len(t), sigma)
    x = x + 2000.0 * np.exp(2j * np.pi * CARRIER_HZ * t + 0.3j)
    _impulses(rng, x, geo, steps, impulses, 3000.0)
    return x.astype(np.complex64)[:, None]


def ssb_tone(geo: Geometry, steps: int, dial_hz: float, *, seed: int = 2,
             offset_hz: float = 700.0, amplitude: float = 10.0,
             sigma: float = 10.0) -> np.ndarray:
    """A keyed tone ``offset_hz`` above the dial, inside the +-1500 Hz
    passband, in noise of sigma 10, beside a carrier of 2000 at
    CARRIER_HZ (SSB, TXTEST, RADAR)."""
    rng = np.random.default_rng(seed)
    t = _time(geo, steps)
    x = (amplitude * _keyed(t, 0.12, 0.5)
         * np.exp(2j * np.pi * (dial_hz + offset_hz) * t))
    x = x + _noise(rng, len(t), sigma)
    x = x + 2000.0 * np.exp(2j * np.pi * CARRIER_HZ * t + 0.3j)
    return x.astype(np.complex64)[:, None]


def meteor_pings(geo: Geometry, steps: int, dial_hz: float, *,
                 seed: int = 3, offset_hz: float = 500.0,
                 amplitude: float = 30.0, sigma: float = 10.0
                 ) -> np.ndarray:
    """Short bursts of a tone ``offset_hz`` above the dial, 15-60 ms long
    with an exponential fade, one to three per step at seeded places, in
    noise of sigma 10 (HSMS: high-speed CW heard only while a meteor
    trail reflects)."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    t = _time(geo, steps)
    env = np.zeros(len(t))
    for s in range(steps):
        for _ in range(int(rng.integers(1, 4))):
            start = s * geo.samples_per_step + int(
                rng.integers(0, geo.samples_per_step))
            width = int(rng.uniform(0.015, 0.060) * fs)
            seg = np.arange(min(width, len(t) - start))
            env[start:start + len(seg)] += np.exp(-3.0 * seg / width)
    x = (amplitude * env * _keyed(t, 0.004, 0.5)
         * np.exp(2j * np.pi * (dial_hz + offset_hz) * t))
    return (x + _noise(rng, len(t), sigma)).astype(np.complex64)[:, None]


def broadcast(geo: Geometry, steps: int, dial_hz: float, fm: bool, *,
              seed: int = 4) -> np.ndarray:
    """A carrier at the dial, amplitude-modulated 50% at 400 Hz (AM) or
    frequency-modulated 3 kHz peak at 400 Hz (FM), amplitude 10, in noise
    of sigma 1."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    t = _time(geo, steps)
    mod = np.sin(2 * np.pi * 400.0 * t)
    if fm:
        sig = 10.0 * np.exp(1j * 2 * np.pi
                            * np.cumsum(dial_hz + 3000.0 * mod) / fs)
    else:
        sig = 10.0 * (1 + 0.5 * mod) * np.exp(2j * np.pi * dial_hz * t)
    return (sig + _noise(rng, len(t), 1.0)).astype(np.complex64)[:, None]


def bare_tone(geo: Geometry, steps: int, dial_hz: float, *,
              offset_hz: float = 300.0, amplitude: float = 10.0
              ) -> np.ndarray:
    """A tone ``offset_hz`` above the dial and nothing else: no noise to
    hide the rounding of the receiver's own arithmetic."""
    t = _time(geo, steps)
    return (amplitude * np.exp(2j * np.pi * (dial_hz + offset_hz) * t)
            ).astype(np.complex64)[:, None]


def mode_input(mode: RxMode, geo: Geometry, steps: int, dial_hz: float
               ) -> np.ndarray:
    """The input that fits ``mode``, for a receiver tuned to ``dial_hz``."""
    mode = RxMode(mode)
    if mode in (RxMode.WCW, RxMode.NCW, RxMode.QRSS):
        return weak_cw(geo, steps, dial_hz,
                       key_period_s=4.0 if mode == RxMode.QRSS else 0.24)
    if mode == RxMode.HSMS:
        return meteor_pings(geo, steps, dial_hz)
    if mode in (RxMode.AM, RxMode.FM):
        return broadcast(geo, steps, dial_hz, fm=mode == RxMode.FM)
    return ssb_tone(geo, steps, dial_hz)


def radar_iq(geo: Geometry, steps: int, *, tx_bin: int, pulse_sep: int,
             pulse_width: int, echo_delay: int, echo_amp: float = 0.05,
             doppler_bins: int = 0, noise: float = 1e-3, seed: int = 7
             ) -> np.ndarray:
    """A radar's own transmitted pulse train leaking into the receiver,
    its delayed (and doppler-shifted) echo and receive noise, with the
    receiver muted during transmit (the condition radar.c:186-193 relies
    on).  Separation, width and delay are in fft1 hops; the carrier sits
    on fft1 bin ``tx_bin``.  Returns (steps * samples_per_step,) complex64."""
    fs = geo.timf1_sampling_speed
    stride = geo.fft1_new_points
    n = steps * geo.samples_per_step
    period = pulse_sep * stride
    delay = echo_delay * stride
    rng = np.random.default_rng(seed)
    env = radar_pulse_train(fs, fs / period, pulse_width * stride / fs,
                            n / fs, rise_s=0.0002)[:n]
    t = np.arange(n)
    tx = env * np.exp(2j * np.pi * tx_bin / geo.fft1_size * t)
    ec = env * np.exp(2j * np.pi * (tx_bin + doppler_bins)
                      / geo.fft1_size * t)
    echo = np.zeros(n, np.complex128)
    echo[delay:] = echo_amp * ec[:-delay]
    nz = noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
    nz *= np.where(env > 0.01, 0.01, 1.0)
    return (tx + echo + nz).astype(np.complex64)
