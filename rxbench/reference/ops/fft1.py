"""First FFT — the wideband analysis stage (port of linrad_tpu/ops/fft1.py).

Windowed overlapped forward transform (``fft1_b``, reference
fft1.c:3302-4084) plus calibration multiply and power-spectrum
accumulation (``fft1_c``, fft1.c:4085-4350).  ``variant="pallas"`` runs
the fused kernel of :mod:`.fused_fft1`; None/``"xla"`` runs torch.fft.
Real input transforms 2N real samples per frame into an N-bin one-sided
spectrum (``torch.fft.rfft``); an ``iq_corr`` table applies the I/Q image
correction.  With either of them ``variant="pallas"`` takes the unfused
torch.fft path, as the JAX package's dispatch does
(linrad_tpu/ops/fft1.py:150): the fused kernel computes neither.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from . import fft as fftlib
from .framing import frame_stream
from .fused_fft1 import fused_fft1
from .windows import make_window


@dataclass(frozen=True)
class FFT1Tables:
    window: torch.Tensor      # (fft1_size,) float32 (2*fft1_size if real)
    filtercorr: torch.Tensor  # (fft1_size, channels) complex64 calibration
    iq_corr: torch.Tensor | None = None  # (fft1_size, C) complex64 foldcorr

    @classmethod
    def create(cls, geo: Geometry, device,
               filtercorr: np.ndarray | None = None,
               iq_corr: np.ndarray | None = None,
               edge_taper: bool = True) -> "FFT1Tables":
        # real input transforms 2N real samples per frame (the
        # real-to-complex fold, fft_cntrl real2complex fft1var.c:43-65)
        wsize = geo.fft1_size if geo.iq_input else 2 * geo.fft1_size
        win = make_window(wsize, geo.fft1_sinpow).astype(np.float32)
        if filtercorr is None:
            fc = np.ones((geo.fft1_size, geo.channels), np.complex64)
            if edge_taper:
                fc *= edge_taper_response(geo)[:, None]
        else:
            fc = np.asarray(filtercorr, np.complex64)
            if fc.ndim == 1:
                fc = fc[:, None]
        iq = None
        if iq_corr is not None:
            iq = np.asarray(iq_corr, np.complex64)
            if iq.ndim == 1:
                iq = iq[:, None]
            iq = torch.from_numpy(iq).to(device)
        return cls(window=torch.from_numpy(win).to(device),
                   filtercorr=torch.from_numpy(fc).to(device),
                   iq_corr=iq)


def edge_taper_response(geo: Geometry) -> np.ndarray:
    """Copy of linrad_tpu.ops.fft1.edge_taper_response: sin^2 taper of
    the 4 bins on each side of the IQ band edge (bin N/2), the default
    uncalibrated response (clear_fft1_filtercorr fft1.c:5196-5222).  Real
    input tapers the top (Nyquist-side) bins instead."""
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
    tail: torch.Tensor       # (interleave, C) complex64; real input:
    #                          (2*interleave, C) float32
    sumsq_avg: torch.Tensor  # (fft1_size, C) float32 averaged |X|^2

    @classmethod
    def create(cls, geo: Geometry, device) -> "FFT1State":
        if geo.iq_input:
            tail = torch.zeros((geo.fft1_interleave_points, geo.channels),
                               dtype=torch.complex64, device=device)
        else:
            tail = torch.zeros((2 * geo.fft1_interleave_points,
                                geo.channels), dtype=torch.float32,
                               device=device)
        return cls(
            tail=tail,
            sumsq_avg=torch.full((geo.fft1_size, geo.channels), 1e-20,
                                 dtype=torch.float32, device=device))


def fft1_step(geo: Geometry, tables: FFT1Tables, state: FFT1State,
              block, avg1num: int, variant: str | None = None,
              reduce=None):
    """Transform one step of input.

    block: (samples_per_step, C) complex64, or (2*samples_per_step, C)
    float32 for real input.  Returns (new_state, spectra
    (fft1_frames_per_step, fft1_size, C) complex64, step_power (fft1_size,
    C) float32 — this step's mean power spectrum).  ``sumsq_avg`` is an
    EMA whose weight matches an ``avg1num``-transform boxcar.

    ``variant="pallas"`` launches the fused kernel for IQ input without
    ``iq_corr``; with real input or ``iq_corr`` it runs the torch.fft path
    (the JAX package's own dispatch, not a fallback).

    ``reduce`` is the time-sharded step's hook, the JAX version's
    ``axis_name``: ``tables``, ``state.tail`` and ``block`` are then lists
    with one entry per local shard (the caller exchanges the framing tails
    between shards), and ``reduce`` maps the list of the shards' mean power
    spectra to their mean over every shard (``parallel.group``'s
    ``pmean``), so that ``step_power`` and ``sumsq_avg`` are the one
    replicated value.  The spectra and new tails come back as lists.  As
    in the JAX package, a reduced call never takes the fused kernel."""
    alpha = min(1.0, geo.fft1_frames_per_step / max(avg1num, 1))
    if reduce is not None:
        parts = [_spectra(geo, t, tail, b, None)
                 for t, tail, b in zip(tables, state.tail, block)]
        specs, tails, powers = (list(x) for x in zip(*parts))
        step_power = reduce(powers)
        sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
        return FFT1State(tail=tails, sumsq_avg=sumsq), specs, step_power
    if geo.iq_input and variant == "pallas" and tables.iq_corr is None:
        frames, new_tail = frame_stream(state.tail, block, geo.fft1_size,
                                        geo.fft1_new_points)
        spec, psum = fused_fft1(frames, tables.window, tables.filtercorr)
        step_power = psum / geo.fft1_frames_per_step
        sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
        return FFT1State(tail=new_tail, sumsq_avg=sumsq), spec, step_power
    if variant == "pallas":  # real input or iq_corr: no fused path
        variant = None
    spec, new_tail, step_power = _spectra(geo, tables, state.tail, block,
                                          variant)
    sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
    return FFT1State(tail=new_tail, sumsq_avg=sumsq), spec, step_power


def _spectra(geo: Geometry, tables: FFT1Tables, tail: torch.Tensor,
             block: torch.Tensor, variant: str | None):
    """The unfused transform of one block: (calibrated spectra, new tail,
    their mean power spectrum)."""
    if geo.iq_input:
        frames, new_tail = frame_stream(tail, block, geo.fft1_size,
                                        geo.fft1_new_points)
        spec = fftlib.fft(frames * tables.window[None, :, None], axis=1,
                          variant=variant)
    else:
        spec, new_tail = fft1_real_step(geo, tables.window, tail, block)
    if tables.iq_corr is not None:
        # I/Q image correction X'[k] = X[k] - c[k]*conj(X[-k])
        # (expand_foldcorr application, caliq.c:40-80); the mirror index
        # (-k) % N is a flip rolled by one, bin 0 staying in place
        mirror = torch.roll(torch.flip(spec, dims=(1,)), 1, dims=1).conj()
        spec = spec - tables.iq_corr[None, :, :] * mirror
    spec = spec * tables.filtercorr[None, :, :]
    return spec, new_tail, (spec.real ** 2 + spec.imag ** 2).mean(0)


def fft1_real_step(geo: Geometry, window2n: torch.Tensor, tail: torch.Tensor,
                   block: torch.Tensor, variant: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real input: 2N real samples -> N-bin one-sided spectrum (the
    reference folds real input into a half-size complex transform,
    real2complex descriptors fft1var.c:43-65; here ``torch.fft.rfft``).

    tail: (2*interleave, C) float32; block: (2*samples_per_step, C)
    float32.  Returns (spectra (n, fft1_size, C) complex64, new_tail)."""
    frames, new_tail = frame_stream(tail, block, 2 * geo.fft1_size,
                                    2 * geo.fft1_new_points)
    windowed = frames * window2n[None, :, None]
    return _pack_onesided(torch.fft.rfft(windowed, dim=1),
                          geo.fft1_size), new_tail


def _pack_onesided(full: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N+1, C) rfft bins -> (..., N, C) one-sided spectrum with the
    Nyquist component packed into bin 0 as DC + i*Nyquist.

    The reference keeps all the information of the 2N real samples in its
    N-bin spectrum by packing both purely real edge bins into one slot
    (fft1_reherm_dit_one, fft1_re.c:100-102); without it the wideband
    timf2 reconstruction loses the Nyquist component."""
    spec = full[..., :n, :].clone()
    # full[0] + 1j * Re(full[N]): the Nyquist's real part goes to the
    # imaginary part, its own imaginary part (zero up to rounding) drops
    spec[..., 0, :] = torch.complex(full[..., 0, :].real,
                                    full[..., 0, :].imag
                                    + full[..., n, :].real)
    return spec
