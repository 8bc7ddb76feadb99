"""CW keying and pulse-train generation (port of linrad_tpu/tx/keying.py,
a copy).

A re-design of ``do_cw_keying`` (reference tx.c:658): hand/tone/ASCII keying
with rise-time-shaped pulses, plus the radar pulse trains of the EME
radar mode (radar.c) and the TX pilot tone."""

from __future__ import annotations

import numpy as np

from ..utils.host import to_numpy
from ..weak.cw import MORSE_ENCODE


def _shape_edges(key: np.ndarray, fs: float, rise_s: float) -> np.ndarray:
    """Raised-cosine rise/fall shaping (the shaped keying of tx.c:658 —
    clicks are -N dB down set by the rise time)."""
    r = max(1, int(rise_s * fs))
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(r) / r))
    kern = np.concatenate([ramp, ramp[::-1]])
    kern /= kern.sum()
    out = np.convolve(key.astype(np.float64), kern, mode="same")
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def cw_envelope(on_off: np.ndarray, fs: float,
                rise_s: float = 0.005) -> np.ndarray:
    """Shape a binary keying sequence into an amplitude envelope."""
    return _shape_edges(to_numpy(on_off, np.float32), fs, rise_s)


def ascii_keying(text: str, fs: float, wpm: float) -> np.ndarray:
    """ASCII -> binary keying sequence at the sample rate (the ASCII
    keying queue of tx.c)."""
    dot = int(round(1.2 / wpm * fs))
    key: list[int] = []
    for ch in text.upper():
        if ch == " ":
            key.extend([0] * (7 * dot))
            continue
        code = MORSE_ENCODE.get(ch)
        if code is None:
            continue
        for s in code:
            key.extend([1] * (dot if s == "." else 3 * dot))
            key.extend([0] * dot)
        key.extend([0] * (2 * dot))
    return np.array(key, np.float32)


def radar_pulse_train(fs: float, prf_hz: float, pulse_s: float,
                      duration_s: float, rise_s: float = 0.0005
                      ) -> np.ndarray:
    """EME radar pulse train envelope (radar.c: synchronized TX pulses
    for range-gated reception)."""
    n = int(duration_s * fs)
    period = int(round(fs / prf_hz))
    width = int(round(pulse_s * fs))
    key = np.zeros(n, np.float32)
    for start in range(0, n - width, period):
        key[start: start + width] = 1.0
    return _shape_edges(key, fs, rise_s)


def range_gate(rx_iq: np.ndarray, fs: float, prf_hz: float,
               n_gates: int) -> np.ndarray:
    """Fold received samples into range gates synchronised to the PRF
    (the radar display accumulation, radar.c).  Returns (n_gates,)
    average power per gate."""
    rx_iq = to_numpy(rx_iq)
    period = int(round(fs / prf_hz))
    n = len(rx_iq) // period
    folded = np.abs(rx_iq[: n * period].reshape(n, period)) ** 2
    prof = folded.mean(axis=0)
    edges = np.linspace(0, period, n_gates + 1).astype(int)
    return np.array([prof[a:b].mean() if b > a else 0.0
                     for a, b in zip(edges[:-1], edges[1:])],
                    np.float32)


def pilot_tone(fs: float, n: int, freq_hz: float, level: float,
               start: int = 0) -> np.ndarray:
    """TX pilot tone (tx.c pilot tone support)."""
    t = start + np.arange(n, dtype=np.float64)
    return (level * np.exp(2j * np.pi * freq_hz / fs * t)
            ).astype(np.complex64)
