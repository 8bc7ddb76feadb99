"""Receiver → network tap publishing (port of linrad_tpu/io/publish.py).

Glue between the pipeline outputs and the multicast stage taps
(io/taps.py): a TapPublisher registered as a receiver hook exports the
selected stage boundaries every step, making the receiver a Linrad-style
*master* (do_network_send, rxin.c:669) that slaves elsewhere on the LAN
can consume as their input.  The outputs may lie on the card: each is
copied to the host (:func:`..utils.host.to_numpy`) before it is sent."""

from __future__ import annotations

import numpy as np

from ..utils.host import to_numpy
from . import taps


class TapPublisher:
    """Publishes pipeline outputs on multicast taps.

    ``formats`` maps tap codes to RxOutputs attributes:
        taps.TAP_FFT1  -> complex fft1 spectra are not in RxOutputs
                          (too large); the published FFT1 tap carries the
                          per-step power spectrum
        taps.TAP_FFT2  -> fft2 step power
        taps.TAP_BASEB -> demodulated audio
        taps.TAP_BASEBRAW -> complex filtered baseband

    dest: optional {tap code: (host, port)}, a unicast destination per
    format instead of its multicast group (:class:`taps.TapSender`).
    """

    DEFAULT = {
        taps.TAP_FFT1: "fft1_power",
        taps.TAP_BASEB: "audio",
        taps.TAP_BASEBRAW: "baseb",
    }

    def __init__(self, formats: dict | None = None,
                 passband_center_mhz: float = 0.0, *,
                 dest: dict | None = None):
        self.formats = dict(formats or self.DEFAULT)
        self.senders = {}
        for fmt in self.formats:
            s = taps.TapSender(fmt, dest=(dest or {}).get(fmt))
            s.header.passband_center = passband_center_mhz
            self.senders[fmt] = s

    def __call__(self, receiver, out) -> None:
        """Receiver 'block' hook signature."""
        for fmt, attr in self.formats.items():
            val = getattr(out, attr, None)
            if val is None:
                continue
            self.senders[fmt].send(to_numpy(val))

    def attach(self, receiver) -> None:
        receiver.add_hook("block", self)

    def close(self) -> None:
        for s in self.senders.values():
            s.flush()
            s.close()


def export_spectravue_wav(path: str, iq: np.ndarray, sample_rate: int,
                          center_freq_hz: int, bits: int = 16) -> None:
    """Write a SpectraVue-compatible WAV (auxi chunk) — the sim2* format
    converter role (sim2spectravue.c etc., SURVEY.md §4.5)."""
    from .wav import AuxiChunk, write_wav

    au = AuxiChunk(center_freq=int(center_freq_hz),
                   ad_frequency=int(sample_rate),
                   bandwidth=int(sample_rate * 0.95))
    write_wav(path, to_numpy(iq), sample_rate, bits=bits, auxi=au)


def export_perseus_wav(path: str, iq: np.ndarray, sample_rate: int,
                       center_freq_hz: int, bits: int = 24) -> None:
    """Write a Perseus-compatible WAV (rcvr chunk) — sim2perseus.c
    analog."""
    from .wav import RcvrChunk, write_wav

    rate_idx = {125_000: 0, 250_000: 1, 500_000: 2,
                1_000_000: 3}.get(int(sample_rate), 0)
    rc = RcvrChunk(center_frequency_hz=int(center_freq_hz),
                   sampling_rate_idx=rate_idx)
    write_wav(path, to_numpy(iq), sample_rate, bits=bits, rcvr=rc)


def export_powersdr_wav(path: str, iq: np.ndarray, sample_rate: int,
                        full_scale: float = 32768.0) -> None:
    """Write a PowerSDR-compatible WAV: 32-bit IEEE float samples
    normalized to +-1 (sim2powersdr.c:295 divides by 0x7fffffff)."""
    from .wav import write_wav

    write_wav(path, to_numpy(iq) / full_scale, sample_rate, bits=32)


def export_qs1r_wav(path: str, iq: np.ndarray, sample_rate: int,
                    center_freq_hz: int = 0,
                    full_scale: float = 32768.0) -> None:
    """Write a QS1R-compatible WAV: 32-bit integer PCM with the
    Perseus ``rcvr`` chunk preserved (sim2qs1r.c:224 widens 16/24-bit
    input to 32-bit int and copies the hardware chunks)."""
    from .wav import RcvrChunk, write_wav

    scaled = to_numpy(iq) * (2147483647.0 / full_scale)
    rc = RcvrChunk(center_frequency_hz=int(center_freq_hz),
                   sampling_rate_idx=0)
    write_wav(path, scaled, sample_rate, bits=32, pcm32=True, rcvr=rc)
