"""Modulators: audio -> complex IQ baseband for the TX D/A (port of
linrad_tpu/tx/modulate.py, a copy).

The reference generates TX signals inside tx.c (CW via keyed carrier,
SSB via the processed speech path); these functions produce the
equivalent IQ streams for the file/device output harness."""

from __future__ import annotations

import numpy as np

from ..utils.host import to_numpy


def ssb_modulate(audio: np.ndarray, fs: float, usb: bool = True
                 ) -> np.ndarray:
    """SSB: analytic signal of the audio (FFT Hilbert), USB or LSB."""
    n = len(audio)
    spec = np.fft.fft(to_numpy(audio, np.float64))
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[1: (n + 1) // 2] = 2.0
    z = np.fft.ifft(spec * h)
    if not usb:
        z = np.conj(z)
    return z.astype(np.complex64)


def am_modulate(audio: np.ndarray, depth: float = 0.8) -> np.ndarray:
    a = to_numpy(audio, np.float64)
    a = a / max(np.abs(a).max(), 1e-9)
    return ((1.0 + depth * a) + 0.0j).astype(np.complex64)


def fm_modulate(audio: np.ndarray, fs: float, deviation_hz: float
                ) -> np.ndarray:
    a = to_numpy(audio, np.float64)
    a = a / max(np.abs(a).max(), 1e-9)
    phase = 2 * np.pi * deviation_hz / fs * np.cumsum(a)
    return np.exp(1j * phase).astype(np.complex64)


class StreamingSSB:
    """Streaming SSB modulator: overlapped FFT-Hilbert with the centre
    half emitted, so block boundaries carry no splatter (the blockwise
    :func:`ssb_modulate` rings at every edge; the reference's TX chain
    is a continuous sample loop, txssb.c).

    Introduces block/2 samples of delay (report it in the TX delay
    model, tx_total_delay semantics)."""

    def __init__(self, block: int, usb: bool = True):
        if block % 2:
            raise ValueError("block must be even")
        self.block = block
        self.usb = usb
        self._prev = np.zeros(block, np.float64)

    @property
    def delay_samples(self) -> int:
        return self.block // 2

    def process(self, audio: np.ndarray) -> np.ndarray:
        x = to_numpy(audio, np.float64)
        if len(x) != self.block:
            raise ValueError("block size mismatch")
        z = ssb_modulate(np.concatenate([self._prev, x]), fs=1.0,
                         usb=self.usb)
        self._prev = x
        half = self.block // 2
        return z[half: half + self.block].astype(np.complex64)
