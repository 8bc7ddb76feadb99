"""Baseband detectors (port of linrad_tpu/ops/demod.py).  Only the BFO
product detector for SSB/CW (coherent mode 0, mix2.c:1774-1803) is
ported; AM, FM and coherent detection are ROADMAP queue 1 item 13."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BFOState:
    """Phase accumulator for the product detector, wrapped per block."""

    phase: torch.Tensor  # () float32 in [0, 2*pi)

    @classmethod
    def create(cls, device) -> "BFOState":
        return cls(phase=torch.zeros((), dtype=torch.float32, device=device))


def bfo_ssb(state: BFOState, baseb: torch.Tensor, bfo_hz: float,
            fs: float) -> tuple[BFOState, torch.Tensor]:
    """audio = Re{z * exp(i*2*pi*bfo*t)}; baseb (S, C) complex64."""
    s = baseb.shape[0]
    dphi = float(np.float32(2.0 * math.pi * bfo_hz / fs))
    ph = state.phase + dphi * torch.arange(s, dtype=torch.float32,
                                           device=baseb.device)
    lo = torch.complex(torch.cos(ph), torch.sin(ph))
    audio = (baseb * lo[:, None]).real
    new_phase = torch.remainder(state.phase + dphi * s, 2.0 * math.pi)
    return BFOState(phase=new_phase), audio
