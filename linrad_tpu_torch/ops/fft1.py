"""First FFT — the wideband analysis stage (port of linrad_tpu/ops/fft1.py).

Windowed overlapped forward transform (``fft1_b``, reference
fft1.c:3302-4084) plus calibration multiply and power-spectrum
accumulation (``fft1_c``, fft1.c:4085-4350).  ``variant="pallas"`` runs
the fused kernel of :mod:`.fused_fft1`; None/``"xla"`` runs torch.fft.
Only complex (IQ) input without I/Q image correction is ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from linrad_tpu.geometry import Geometry
from linrad_tpu.ops.windows import make_window

from . import fft as fftlib
from .framing import frame_stream
from .fused_fft1 import fused_fft1


@dataclass(frozen=True)
class FFT1Tables:
    window: torch.Tensor      # (fft1_size,) float32
    filtercorr: torch.Tensor  # (fft1_size, channels) complex64 calibration

    @classmethod
    def create(cls, geo: Geometry, device,
               filtercorr: np.ndarray | None = None) -> "FFT1Tables":
        win = make_window(geo.fft1_size, geo.fft1_sinpow).astype(np.float32)
        if filtercorr is None:
            fc = np.ones((geo.fft1_size, geo.channels), np.complex64)
            fc *= edge_taper_response(geo)[:, None]
        else:
            fc = np.asarray(filtercorr, np.complex64)
            if fc.ndim == 1:
                fc = fc[:, None]
        return cls(window=torch.from_numpy(win).to(device),
                   filtercorr=torch.from_numpy(fc).to(device))


def edge_taper_response(geo: Geometry) -> np.ndarray:
    """Copy of linrad_tpu.ops.fft1.edge_taper_response: sin^2 taper of
    the 4 bins on each side of the IQ band edge (bin N/2), the default
    uncalibrated response (clear_fft1_filtercorr fft1.c:5196-5222)."""
    n = geo.fft1_size
    taper = np.array([np.sin(j * np.pi / 8) ** 2 for j in range(4)],
                     np.float32)
    r = np.ones(n, np.float32)
    if geo.iq_input:
        for j in range(4):
            r[(n // 2 + j) % n] = taper[j]
            r[(n // 2 - 1 - j) % n] = taper[j]
    else:
        for j in range(4):
            r[n - 1 - j] = taper[j]
    return r


@dataclass
class FFT1State:
    tail: torch.Tensor       # (interleave, C) complex64
    sumsq_avg: torch.Tensor  # (fft1_size, C) float32 averaged |X|^2

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT1State":
        return cls(
            tail=torch.zeros((geo.fft1_interleave_points, geo.channels),
                             dtype=torch.complex64, device=device),
            sumsq_avg=torch.full((geo.fft1_size, geo.channels), 1e-20,
                                 dtype=torch.float32, device=device))


def fft1_step(geo: Geometry, tables: FFT1Tables, state: FFT1State,
              block: torch.Tensor, avg1num: int, variant: str | None = None
              ) -> tuple[FFT1State, torch.Tensor, torch.Tensor]:
    """Transform one step of IQ input.

    block: (samples_per_step, C) complex64.  Returns (new_state, spectra
    (fft1_frames_per_step, fft1_size, C) complex64, step_power (fft1_size,
    C) float32 — this step's mean power spectrum).  ``sumsq_avg`` is an
    EMA whose weight matches an ``avg1num``-transform boxcar."""
    if not geo.iq_input:
        raise NotImplementedError("real-input fft1 is not ported; see "
                                  "ROADMAP queue 1 item 13")
    frames, new_tail = frame_stream(state.tail, block, geo.fft1_size,
                                    geo.fft1_new_points)
    alpha = min(1.0, geo.fft1_frames_per_step / max(avg1num, 1))
    if variant == "pallas":
        spec, psum = fused_fft1(frames, tables.window, tables.filtercorr)
        step_power = psum / geo.fft1_frames_per_step
    else:
        spec = fftlib.fft(frames * tables.window[None, :, None], axis=1,
                          variant=variant)
        spec = spec * tables.filtercorr[None, :, :]
        step_power = (spec.real ** 2 + spec.imag ** 2).mean(0)
    sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
    return FFT1State(tail=new_tail, sumsq_avg=sumsq), spec, step_power
