"""Third FFT — baseband spectrum for filtering (port of
linrad_tpu/ops/fft3.py, reference ``do_fft3`` fft3.c:35/215)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from .framing import frame_stream
from .windows import make_window


@dataclass(frozen=True)
class FFT3Tables:
    window: torch.Tensor  # (fft3_size,) float32

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT3Tables":
        win = make_window(geo.fft3_size, geo.fft3_sinpow).astype(np.float32)
        return cls(window=torch.from_numpy(win).to(device))


@dataclass
class FFT3State:
    tail: torch.Tensor  # (..., fft3_interleave, C) complex64

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT3State":
        return cls(tail=torch.zeros((geo.fft3_interleave_points,
                                     geo.channels), dtype=torch.complex64,
                                    device=device))


def fft3_step(geo: Geometry, tables: FFT3Tables, state: FFT3State,
              timf3: torch.Tensor) -> tuple[FFT3State, torch.Tensor]:
    """timf3 (..., S3, C) -> fft3 spectra (..., n3, fft3_size, C)."""
    frames, new_tail = frame_stream(state.tail, timf3, geo.fft3_size,
                                    geo.fft3_new_points)
    spec = torch.fft.fft(frames * tables.window[:, None], dim=-2)
    return FFT3State(tail=new_tail), spec
