"""First mixer / decimator — frequency-domain downconversion (port of
linrad_tpu/ops/mix1.py, reference ``do_mix1`` mix1.c:55-647).

``mix1.size`` bins around the tuned bin are taken from each fftx
transform, weighted by the erfc window ``mix1_fqwin``, inverse
transformed at 1/decimation size and overlap-added into the timf3
baseband stream.  The per-frame rotation is tracked as an integer phase
index (c*H mod N), so there is no drift; the tuned bin is a tensor, so
retuning changes no shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import erfc

from linrad_tpu.geometry import Geometry
from linrad_tpu.ops.windows import synthesis_weights

from .framing import overlap_add


def fqwin_weight(bin_offset: np.ndarray, mix1_size: int) -> np.ndarray:
    """Copy of linrad_tpu.ops.mix1.fqwin_weight: the mix1_fqwin erfc
    taper (make_window mode 5, fft0.c:818-829) at (possibly fractional)
    bin offset from the band centre: win[M/2 - max(|d|, 1)]."""
    m = mix1_size
    d = np.abs(bin_offset)
    return 0.5 * erfc(3.2 - 13.0 * (m // 2 - np.maximum(d, 1.0)) / m)


def _signed_bins(m: int) -> np.ndarray:
    """0..m/2-1, -m/2..-1: small-FFT bin -> offset from the centre."""
    return np.where(np.arange(m) < m // 2, np.arange(m), np.arange(m) - m)


def signed_bins(m: int, device) -> torch.Tensor:
    """_signed_bins made on the device (no host-to-device copy)."""
    k = torch.arange(m, device=device)
    return torch.where(k < m // 2, k, k - m)


@dataclass(frozen=True)
class Mix1Tables:
    fqwin: torch.Tensor  # (M,) float32, FFT-shifted order
    syn: torch.Tensor    # (M,) float32 overlap-add synthesis weights

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix1Tables":
        m = geo.mix1_size
        fqwin = fqwin_weight(_signed_bins(m), m)
        sinpow = geo.fft2_sinpow if geo.second_fft_enable else geo.fft1_sinpow
        syn = synthesis_weights(m, geo.mix1_interleave_points, sinpow)
        return cls(fqwin=torch.as_tensor(fqwin, dtype=torch.float32,
                                         device=device),
                   syn=torch.as_tensor(syn, dtype=torch.float32,
                                       device=device))


@dataclass
class Mix1State:
    phase_idx: torch.Tensor   # () int32 — phase in units of 1/N turn
    ola_carry: torch.Tensor   # (mix1_interleave, C) complex64
    frac_phase: torch.Tensor  # () float32 — fractional-tune phase, turns

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix1State":
        return cls(
            phase_idx=torch.zeros((), dtype=torch.int32, device=device),
            ola_carry=torch.zeros((geo.mix1_interleave_points, geo.channels),
                                  dtype=torch.complex64, device=device),
            frac_phase=torch.zeros((), dtype=torch.float32, device=device))


def mix1_step(geo: Geometry, tables: Mix1Tables, state: Mix1State,
              spectra: torch.Tensor, center_bins: torch.Tensor,
              tune_frac: torch.Tensor | None = None
              ) -> tuple[Mix1State, torch.Tensor]:
    """Downconvert one step of fftx spectra to the timf3 stream.

    spectra: (n, N, C) complex64 fftx transforms at hop H samples;
    center_bins: () or (n,) integer tuned bin(s); tune_frac: optional () or
    (n,) float32 fractional bin offset (set_mix1_phases mix1.c:781-860).

    Returns (new_state, timf3 (n * mix1_new_points, C) complex64)."""
    n, big_n, c = spectra.shape
    m = geo.mix1_size
    hop = geo.fftx_new_points
    dev = spectra.device
    center = torch.broadcast_to(center_bins.to(torch.int64), (n,))
    rel = signed_bins(m, dev)
    bins = torch.remainder(center[:, None] + rel[None, :], big_n)  # (n, M)
    sel = torch.gather(spectra, 1, bins[:, :, None].expand(n, m, c))
    sel = sel * tables.fqwin[None, :, None]
    y = torch.fft.ifft(sel, dim=1) * (m / big_n)

    # Integer phase bookkeeping: frame b is rotated by exp(-2 pi i phi_b/N)
    # with phi advancing by c_b*H (mod N) per frame.  The JAX version
    # wraps in uint32; int64 with & (N-1) gives the same residues exactly
    # for power-of-two N.
    mask = big_n - 1
    incr = (center * hop) & mask
    cum = torch.cumsum(incr, 0) - incr  # exclusive prefix
    phase0 = state.phase_idx.to(torch.int64)
    idx = (phase0 + cum) & mask
    theta = (-2.0 * math.pi / big_n) * idx.to(torch.float32)
    y = y * torch.complex(torch.cos(theta), torch.sin(theta))[:, None, None]
    new_phase = ((phase0 + incr.sum()) & mask).to(torch.int32)

    timf3, carry = overlap_add(y * tables.syn[None, :, None],
                               geo.mix1_new_points, state.ola_carry)
    new_frac = state.frac_phase
    if tune_frac is not None:
        ramp, new_frac = frac_ramp(geo, state.frac_phase, tune_frac, n)
        timf3 = timf3 * ramp[:, None]
    return Mix1State(phase_idx=new_phase, ola_carry=carry,
                     frac_phase=new_frac), timf3


def frac_ramp(geo: Geometry, frac_phase: torch.Tensor,
              tune_frac: torch.Tensor, n: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-frequency ramp on the timf3 output: frac big-FFT bins ==
    frac/m turns per timf3 sample (mix1.c:141-234).  The per-frame slope
    of the JAX version (AFC drift tracking) is not ported.

    Returns (complex64 ramp of length n*mix1_new_points, final phase in
    turns)."""
    m = geo.mix1_size
    hop_m = geo.mix1_new_points
    fr = torch.broadcast_to(tune_frac.to(torch.float32), (n,))
    per_samp = torch.repeat_interleave(fr / m, hop_m)
    cum = frac_phase + torch.cumsum(per_samp, 0) - per_samp
    theta = (-2.0 * math.pi) * torch.remainder(cum, 1.0)
    ramp = torch.complex(torch.cos(theta), torch.sin(theta))
    return ramp, torch.remainder(frac_phase + per_samp.sum(), 1.0)
