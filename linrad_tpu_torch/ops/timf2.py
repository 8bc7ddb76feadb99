"""Back transform & weak/strong split -> the timf2 time series (port of
linrad_tpu/ops/timf2.py, reference ``make_timf2`` timf2.c:31-208).

Each fft1 spectrum is split by liminfo into a weak and a strong spectrum;
both go through ONE batched inverse FFT (weak/strong stacked on a leading
axis), then synthesis weights and overlap-add give two continuous time
series, plus the channel-summed weak power the blankers work on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from linrad_tpu.geometry import Geometry
from linrad_tpu.ops.windows import synthesis_weights

from .framing import overlap_add


@dataclass
class Timf2State:
    weak_carry: torch.Tensor    # (fft1_interleave, C) complex64 OLA carry
    strong_carry: torch.Tensor

    @classmethod
    def create(cls, geo: Geometry, device) -> "Timf2State":
        shape = (geo.fft1_interleave_points, geo.channels)
        return cls(weak_carry=torch.zeros(shape, dtype=torch.complex64,
                                          device=device),
                   strong_carry=torch.zeros(shape, dtype=torch.complex64,
                                            device=device))


def make_timf2_syn(geo: Geometry, device) -> torch.Tensor:
    """Synthesis weights for the fft1 inverse transforms."""
    syn = synthesis_weights(geo.fft1_size, geo.fft1_interleave_points,
                            geo.fft1_sinpow)
    return torch.as_tensor(syn, dtype=torch.float32, device=device)


def timf2_step(geo: Geometry, syn: torch.Tensor, state: Timf2State,
               fft1_spec: torch.Tensor, weak_gain: torch.Tensor,
               strong_gain: torch.Tensor):
    """Split + back transform one step of fft1 spectra.

    fft1_spec: (n, N, C) complex64; weak_gain/strong_gain: (N,) float32.
    Returns (state, weak, strong, weak_pwr): weak/strong (n*hop, C)
    complex64, weak_pwr (n*hop,) float32 summed over channels."""
    gains = torch.stack([weak_gain, strong_gain])             # (2, N)
    masked = fft1_spec[None] * gains[:, None, :, None]        # (2, n, N, C)
    frames = torch.fft.ifft(masked, dim=2) \
        * syn[None, None, :, None]
    weak, wc = overlap_add(frames[0], geo.fft1_new_points, state.weak_carry)
    strong, sc = overlap_add(frames[1], geo.fft1_new_points,
                             state.strong_carry)
    weak_pwr = (weak.real ** 2 + weak.imag ** 2).sum(-1)
    return (Timf2State(weak_carry=wc, strong_carry=sc), weak, strong,
            weak_pwr)
