"""Baseband detectors (port of linrad_tpu/ops/demod.py): the BFO product
detector (SSB/CW, coherent mode 0, mix2.c:1774-1803), the AM envelope
(mix2.c:1804-1834), the FM discriminator with de-emphasis (fm.c:93) and
the carrier-locked coherent detector (coherent modes 1/2,
mix2.c:1841-1900).  The recurrences are ``utils.scanops.one_pole``.
Streams are (..., S, C) with the state stacked on the same leading axes,
so one call serves one receiver or K sub-receivers.
``wfm_stereo_decode`` is on no chain path and is not ported."""

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
    ph = state.phase[..., None] + dphi * torch.arange(
        s, dtype=torch.float32, device=baseb.device)
    lo = torch.complex(torch.cos(ph), torch.sin(ph))
    audio = (baseb * lo[..., None]).real
    new_phase = torch.remainder(state.phase + dphi * s, 2.0 * math.pi)
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
