"""Baseband detectors (port of linrad_tpu/ops/demod.py): the BFO product
detector (SSB/CW, coherent mode 0, mix2.c:1774-1803), the AM envelope
(mix2.c:1804-1834), the FM discriminator with de-emphasis (fm.c:93) and
the carrier-locked coherent detector (coherent modes 1/2,
mix2.c:1841-1900).  The recurrences are ``utils.scanops.one_pole``.
Streams are (..., S, C) with the state stacked on the same leading axes,
so one call serves one receiver or K sub-receivers.
``wfm_stereo_decode`` (the broadcast-WFM stereo pilot path, fm.c:373-420)
is on no chain path: it takes a whole demodulated composite block."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.scanops import one_pole


def _pole(tc_samples: float) -> float:
    """exp(-1/tc_samples) evaluated in float32, as the JAX detectors
    evaluate their one-pole coefficients."""
    return float(torch.exp(torch.tensor(-1.0 / tc_samples,
                                        dtype=torch.float32)))


@dataclass
class BFOState:
    """Phase accumulator for the product detector, wrapped per block."""

    phase: torch.Tensor  # (...,) float32 in [0, 2*pi)

    @classmethod
    def create(cls, device) -> "BFOState":
        return cls(phase=torch.zeros((), dtype=torch.float32, device=device))


def bfo_ssb(state: BFOState, baseb: torch.Tensor, bfo_hz: float,
            fs: float) -> tuple[BFOState, torch.Tensor]:
    """audio = Re{z * exp(i*2*pi*bfo*t)}; baseb (..., S, C) complex64."""
    s = baseb.shape[-2]
    dphi = float(np.float32(2.0 * math.pi * bfo_hz / fs))
    # phase + dphi*n rounded to float32 once, as XLA contracts it into a
    # fused multiply-add: a product and a sum rounded apart put the
    # argument, thousands of radians by the end of a step, one ulp away
    # (2.4e-4 rad at 4,096 samples), and the audio as far from JAX's
    phase = state.phase.to(torch.float64)
    ph = (phase[..., None] + dphi * torch.arange(
        s, dtype=torch.float64, device=baseb.device)).to(torch.float32)
    lo = torch.complex(torch.cos(ph), torch.sin(ph))
    audio = (baseb * lo[..., None]).real
    new_phase = torch.remainder((phase + dphi * s).to(torch.float32),
                                2.0 * math.pi)
    return BFOState(phase=new_phase), audio


@dataclass
class AMState:
    dc: torch.Tensor  # (..., C) float32 — tracked carrier DC level

    @classmethod
    def create(cls, channels: int, device) -> "AMState":
        return cls(dc=torch.zeros((channels,), dtype=torch.float32,
                                  device=device))


def am_detect(state: AMState, baseb: torch.Tensor, fs: float,
              dc_tc_s: float = 0.05) -> tuple[AMState, torch.Tensor]:
    """Envelope detector: |z| minus its DC, the DC from a one-pole."""
    env = baseb.abs()
    dc, dc_last = one_pole(env, _pole(fs * dc_tc_s), state.dc, dim=-2)
    return AMState(dc=dc_last), env - dc


@dataclass
class FMState:
    last: torch.Tensor    # (..., C) complex64 — previous baseband sample
    deemph: torch.Tensor  # (..., C) float32 — de-emphasis filter carry

    @classmethod
    def create(cls, channels: int, device) -> "FMState":
        return cls(last=torch.ones((channels,), dtype=torch.complex64,
                                   device=device),
                   deemph=torch.zeros((channels,), dtype=torch.float32,
                                      device=device))


def fm_detect(state: FMState, baseb: torch.Tensor, fs: float,
              deviation_hz: float = 5000.0) -> tuple[FMState, torch.Tensor]:
    """Angle-difference discriminator: the phase step between consecutive
    samples, scaled to +-1 at the rated deviation."""
    prev = torch.cat([state.last[..., None, :], baseb[..., :-1, :]], dim=-2)
    prod = baseb * prev.conj()
    audio = torch.atan2(prod.imag, prod.real)
    audio = audio * float(np.float32(fs / (2.0 * math.pi * deviation_hz)))
    return FMState(last=baseb[..., -1, :], deemph=state.deemph), audio


def fm_deemphasis(audio: torch.Tensor, fs: float, tau_us: float,
                  y0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FM de-emphasis one-pole (tau 50 us EU, 75 us US).  Returns (audio,
    carry)."""
    return one_pole(audio, _pole(fs * tau_us * 1e-6), y0, dim=-2)


def wfm_stereo_decode(composite: torch.Tensor, fs: float,
                      audio_cut_hz: float = 15_000.0,
                      pilot_hz: float = 19_000.0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Broadcast-WFM stereo decode of an FM-demodulated composite
    (the fm.c wideband-stereo pilot path, fm.c:373-420): correlate the
    19 kHz pilot against a complex exponential to recover its phase,
    coherently demodulate the 38 kHz DSB L-R subcarrier with the doubled
    pilot phase, low-pass both channels, and matrix to L/R.

    Vectorized over the whole block (FFT filtering instead of the
    reference's FIR ring walks).  composite: (n,) float at fs (must
    exceed ~2*53 kHz), on the device the decode is to run on.  Returns
    (left, right, pilot_power_ratio), the last a 0-dim tensor.

    The time axis and the sine's argument are built in float32 in the
    JAX function's order, (2 pi pilot_hz) * (k / fs): at a second of
    signal the argument is 2.4e5 rad, where one float32 step is 0.016
    rad, so another order would move the phases by far more than
    roundoff."""
    x = composite.to(torch.float32)
    n = x.shape[0]
    dev = x.device
    # the rate as a tensor on the device: by a Python scalar a CUDA tensor
    # is multiplied by the reciprocal, which is not the quotient
    t = torch.arange(n, dtype=torch.float32, device=dev) / torch.full(
        (), float(np.float32(fs)), dtype=torch.float32, device=dev)
    w = float(np.float32(2 * np.pi) * np.float32(pilot_hz))
    wt = w * t
    # pilot phase from the whole-block correlation (fm.c:381-393)
    ref = torch.complex(torch.cos(wt), -torch.sin(wt))
    pil = torch.sum(x * ref) * (2.0 / n)
    pilot_pwr = pil.abs() ** 2 / torch.clamp(torch.mean(x * x), min=1e-20)
    ph = torch.angle(pil)
    # 38 kHz coherent subcarrier at doubled pilot phase.  The standard
    # ties the subcarrier's positive-slope zero crossings to the
    # pilot's: pilot = sin(theta) = cos(omega*t + ph) with
    # theta = omega*t + ph + pi/2, subcarrier = sin(2*theta)
    # = -sin(2*(omega*t + ph))
    sub = -torch.sin(2 * (wt + ph))
    lmr_raw = 2.0 * x * sub
    # FFT brick-wall low-pass with raised-cosine edge at audio_cut_hz
    freqs = torch.fft.fftfreq(n, 1.0 / fs, dtype=torch.float32,
                              device=dev).abs()
    edge = 0.1 * audio_cut_hz
    gain = torch.clamp((audio_cut_hz + edge - freqs) / edge, 0.0, 1.0)
    gain = torch.sin(0.5 * math.pi * gain) ** 2

    def lp(sig):
        return torch.fft.ifft(torch.fft.fft(sig) * gain).real

    lpr = lp(x)          # L+R (the mono signal, at most 15 kHz + trash)
    lmr = lp(lmr_raw)    # L-R
    return 0.5 * (lpr + lmr), 0.5 * (lpr - lmr), pilot_pwr


def wfm_stereo_encode(left: np.ndarray, right: np.ndarray, fs: float,
                      pilot_level: float = 0.1,
                      pilot_hz: float = 19_000.0) -> np.ndarray:
    """Test-vector generator: the standard stereo multiplex
    (L+R)/2 + pilot·sin(theta) + (L-R)/2·sin(2·theta): the subcarrier
    crosses zero upward together with the pilot (FCC/ITU phasing)."""
    t = np.arange(len(left)) / fs
    return ((left + right) / 2
            + pilot_level * np.sin(2 * np.pi * pilot_hz * t)
            + ((left - right) / 2) * np.sin(4 * np.pi * pilot_hz * t)
            ).astype(np.float32)


@dataclass
class CoherentState:
    """Carrier-phase tracking for coherent modes 1/2."""

    phase: torch.Tensor  # (..., C) complex64 — smoothed carrier phasor

    @classmethod
    def create(cls, channels: int, device) -> "CoherentState":
        return cls(phase=torch.ones((channels,), dtype=torch.complex64,
                                    device=device))


def coherent_detect(state: CoherentState, baseb: torch.Tensor,
                    carrier: torch.Tensor, fs: float, tc_s: float = 0.05
                    ) -> tuple[CoherentState, torch.Tensor, torch.Tensor]:
    """Carrier-locked I/Q demodulation (coherent mode 2).

    The carrier branch's real and imaginary parts are smoothed by a
    one-pole each, normalised to a unit phasor, and the wide branch is
    rotated by its conjugate.  Returns (state, audio_i, audio_q)."""
    a = _pole(fs * tc_s)
    sm_r, last_r = one_pole(carrier.real.contiguous(), a, state.phase.real,
                            dim=-2)
    sm_i, last_i = one_pole(carrier.imag.contiguous(), a, state.phase.imag,
                            dim=-2)
    sm = torch.complex(sm_r, sm_i)
    unit = sm / torch.clamp(sm.abs(), min=1e-20)
    z = baseb * unit.conj()
    return (CoherentState(phase=torch.complex(last_r, last_i)), z.real,
            z.imag)
