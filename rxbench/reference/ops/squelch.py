"""Squelch and audio expander (port of linrad_tpu/ops/squelch.py).

Squelch (``update_squelch``, reference fft3.c:87-145): the in-passband
fft3 spectral statistics decide signal against noise.  The noise level is
the mean of the smallest in-band bins of the step's spectrum; the gate
opens when the in-band power exceeds ``ratio`` times that floor, and its
level is smoothed so that opening and closing do not click.

Expander: downward expansion below the AGC reference level suppresses
band noise between CW elements.

Both take (..., S, C) audio with the state stacked on the same leading
axes, so one call serves one receiver or K sub-receivers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from .mix1 import signed_bins


@dataclass
class SquelchState:
    gate: torch.Tensor  # (...,) float32 smoothed open fraction 0..1

    @classmethod
    def create(cls, device) -> "SquelchState":
        return cls(gate=torch.zeros((), dtype=torch.float32, device=device))


def squelch_step(geo: Geometry, state: SquelchState,
                 fft3_spec: torch.Tensor, filt: torch.Tensor, ratio: float,
                 tc_ms: float, audio: torch.Tensor
                 ) -> tuple[SquelchState, torch.Tensor, torch.Tensor]:
    """Gate the audio from in-passband fft3 statistics.

    fft3_spec: (..., n3, fft3_size, C); filt: (mix2_size,) the baseband
    filter (its support defines "in passband", fft3.c:97-128); audio
    (..., S, C).  Returns (state, gated audio, open fraction (...,))."""
    m2 = filt.shape[0]
    bins = torch.remainder(signed_bins(m2, filt.device), geo.fft3_size)
    sel = fft3_spec.index_select(-2, bins)
    p = (sel.real ** 2 + sel.imag ** 2).sum(-1).mean(-2)   # (..., m2)
    inband = filt > 0.5 * filt.max()
    n_in = torch.clamp(inband.sum(), min=1)
    # noise floor: the mean of the smallest in-band bins (fft3.c:130-145
    # takes the smallest 20%); k stays well below any realistic passband,
    # so only quiet bins contribute.  Out-of-band bins hold inf and are
    # masked out again should k exceed the in-band count.
    big = torch.where(inband, p, math.inf)
    k = max(2, m2 // 16)
    smallest = torch.topk(big, k, dim=-1, largest=False).values
    finite = torch.isfinite(smallest)
    noise = (torch.where(finite, smallest, 0.0).sum(-1)
             / torch.clamp(finite.sum(-1), min=1))
    signal = torch.where(inband, p, 0.0).sum(-1) / n_in
    open_now = (signal > ratio * torch.clamp(noise, min=1e-30)).to(
        torch.float32)
    # smooth the gate at the audio block rate; the coefficient is static
    a = float(np.exp(np.float32(-audio.shape[-2]
                                / (geo.baseband_sampling_speed * tc_ms
                                   * 1e-3))))
    gate = a * state.gate + (1 - a) * open_now
    return SquelchState(gate=gate), audio * gate[..., None, None], gate


def expander(audio: torch.Tensor, exponent: float,
             ref_level: float = 1.0) -> torch.Tensor:
    """Downward expansion: out = x * (|x|/ref)^(e-1) for |x| < ref."""
    if exponent <= 1.0:
        return audio
    mag = audio.abs() / ref_level
    gain = torch.where(mag < 1.0,
                       torch.clamp(mag, min=1e-9) ** (exponent - 1.0), 1.0)
    return audio * gain
