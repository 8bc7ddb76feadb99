"""Second FFT — high-resolution spectrum after blanking (port of
linrad_tpu/ops/fft2.py, reference ``make_fft2`` fft2.c:52-1848): re-sum
weak+strong (fft2.c:100-116), frame, window and transform all frames of
the step at once."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from .framing import frame_stream
from .windows import make_window


@dataclass(frozen=True)
class FFT2Tables:
    window: torch.Tensor  # (fft2_size,) float32

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT2Tables":
        win = make_window(geo.fft2_size, geo.fft2_sinpow).astype(np.float32)
        return cls(window=torch.from_numpy(win).to(device))


@dataclass
class FFT2State:
    tail: torch.Tensor       # (fft2_interleave, C) complex64
    sumsq_avg: torch.Tensor  # (fft2_size, C) float32 slow power average

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT2State":
        return cls(
            tail=torch.zeros((geo.fft2_interleave_points, geo.channels),
                             dtype=torch.complex64, device=device),
            sumsq_avg=torch.full((geo.fft2_size, geo.channels), 1e-20,
                                 dtype=torch.float32, device=device))


def fft2_transform(geo: Geometry, tables: FFT2Tables, tail: torch.Tensor,
                   weak: torch.Tensor, strong: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """weak/strong (S, C) complex64 -> (new_tail, spectra (n2, fft2_size,
    C))."""
    frames, new_tail = frame_stream(tail, weak + strong, geo.fft2_size,
                                    geo.fft2_new_points)
    spec = torch.fft.fft(frames * tables.window[None, :, None], dim=1)
    return new_tail, spec


def fft2_power_update(geo: Geometry, state: FFT2State,
                      new_tail: torch.Tensor, spec: torch.Tensor,
                      avg2num: int = 8) -> tuple[FFT2State, torch.Tensor]:
    """Step mean power spectrum and its slow average."""
    step_power = (spec.real ** 2 + spec.imag ** 2).mean(0)
    alpha = min(1.0, geo.fft2_frames_per_step / max(avg2num, 1))
    sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
    return FFT2State(tail=new_tail, sumsq_avg=sumsq), step_power


def fft2_step(geo: Geometry, tables: FFT2Tables, state: FFT2State,
              weak: torch.Tensor, strong: torch.Tensor, avg2num: int = 8
              ) -> tuple[FFT2State, torch.Tensor, torch.Tensor]:
    """fft2_transform + fft2_power_update in one call (no spur stage).

    Returns (state, spectra (n2, fft2_size, C), step_power)."""
    new_tail, spec = fft2_transform(geo, tables, state.tail, weak, strong)
    new_state, step_power = fft2_power_update(geo, state, new_tail, spec,
                                              avg2num)
    return new_state, spec, step_power
