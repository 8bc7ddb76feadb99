"""SSB speech processor (port of linrad_tpu/tx/ssbproc.py, a copy).

A re-design of the reference speech processor (txssb.c, 2390
LoC; parameters SSBPROC_PARM globdef.h:392-409; method notes
z_SPEACH_PROCESSOR.txt): mic AGC, bass/treble shaping, optional
frequency shift, clipping/ALC, and filtering — all as frequency-domain
block processing on overlapped frames (the same sin^2 overlap-add
machinery as the RX chain, vectorised over each block)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.host import to_numpy


@dataclass
class SSBProcParams:
    """SSBPROC_PARM analog (globdef.h:392-409)."""

    mic_agc_release_ms: float = 300.0
    bass_db: float = 0.0          # shelf gain below 300 Hz
    treble_db: float = 0.0        # shelf gain above 1800 Hz
    shift_hz: float = 0.0         # spectrum shift (frequency translate)
    alc_level: float = 0.9        # output peak target (ALC)
    clip_db: float = 0.0          # speech clipping depth (0 = off)
    filter_low_hz: float = 200.0
    filter_high_hz: float = 2900.0


class SSBProcessor:
    """Block speech processor: real mic audio -> processed real audio."""

    def __init__(self, fs: float, params: SSBProcParams | None = None,
                 block: int = 2048):
        self.fs = fs
        self.p = params or SSBProcParams()
        self.block = block
        n = block
        freqs = np.fft.rfftfreq(n, 1.0 / fs)
        p = self.p
        shape = np.ones_like(freqs)
        # bass/treble shelves (the bass/treble controls of txssb.c)
        shape *= 10 ** (p.bass_db / 20.0 * np.clip(
            (300.0 - freqs) / 300.0, 0, 1))
        shape *= 10 ** (p.treble_db / 20.0 * np.clip(
            (freqs - 1800.0) / 1200.0, 0, 1))
        # bandpass
        shape *= (freqs >= p.filter_low_hz) & (freqs <= p.filter_high_hz)
        self._shape = shape
        self._win = np.sin(np.pi * np.arange(n) / n) ** 2
        self._agc_env = 1e-6
        self._tail = np.zeros(block // 2)

    def _agc(self, x: np.ndarray) -> np.ndarray:
        # env[i] = max(|x[i]|, rel*env[i-1]) vectorised in the log domain:
        # max over j<=i of (log|x_j| - j*log_rel) + i*log_rel via a
        # running maximum (same max-plus trick as utils/scanops.decay_max)
        rel = 0.5 ** (1e3 / (self.fs * self.p.mic_agc_release_ms))
        lr = np.log(rel)
        idx = np.arange(len(x) + 1)
        la = np.log(np.maximum(
            np.concatenate([[self._agc_env], np.abs(x)]), 1e-9))
        env = np.exp(np.maximum.accumulate(la - idx * lr) + idx * lr)[1:]
        self._agc_env = float(env[-1])
        return x / np.maximum(env, 1e-6)

    def process(self, audio: np.ndarray) -> np.ndarray:
        """Process one block (length = self.block) of mic audio."""
        x = self._agc(to_numpy(audio, np.float64))
        if self.p.clip_db > 0:
            # speech clipping: amplify then hard-limit, filtering removes
            # the splatter (z_SPEACH_PROCESSOR.txt method)
            gain = 10 ** (self.p.clip_db / 20.0)
            x = np.clip(x * gain, -1.0, 1.0)
        n = self.block
        half = n // 2
        out = np.zeros(len(x))
        buf = np.concatenate([self._tail, x])
        for start in range(0, len(x), half):
            seg = buf[start: start + n]
            if len(seg) < n:
                seg = np.pad(seg, (0, n - len(seg)))
            spec = np.fft.rfft(seg * self._win)
            if self.p.shift_hz:
                k = int(round(self.p.shift_hz * n / self.fs))
                spec = np.roll(spec, k)
                if k > 0:
                    spec[:k] = 0
                elif k < 0:
                    spec[k:] = 0
            spec *= self._shape
            y = np.fft.irfft(spec)
            lo = start
            hi = min(start + n, len(out))
            out[lo:hi] += y[: hi - lo]
        self._tail = buf[len(x):]
        # ALC: normalise output peaks to alc_level
        peak = np.abs(out).max()
        if peak > 0:
            out *= min(1.0, self.p.alc_level / peak)
        return out.astype(np.float32)
