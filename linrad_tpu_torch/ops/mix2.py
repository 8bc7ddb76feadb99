"""Second mixer: baseband filter + inverse transform to demod input (port
of linrad_tpu/ops/mix2.py, mixer_mode 1, reference mix2.c:146-216).

``mix2.size`` bins of each fft3 transform centred at DC are multiplied by
the user filter (with the inverse-``mix1_fqwin`` compensation,
baseb_graph.c:3795-3798), inverse transformed and overlap-added to the
baseband stream.  The carrier branch (coherent demodulation) and
mixer_mode 2 (the time-domain FIR) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from linrad_tpu.geometry import Geometry
from linrad_tpu.ops.windows import synthesis_weights
from linrad_tpu.params import RxParams

from .framing import overlap_add
from .mix1 import _signed_bins, fqwin_weight, signed_bins


def _filter_response(freq: np.ndarray, geo: Geometry, low_hz: float,
                     high_hz: float, edge_hz: float = 0.0,
                     compensate_fqwin: bool = True, notches: tuple = (),
                     shape: tuple = ()) -> np.ndarray:
    """Copy of linrad_tpu.ops.mix2._filter_response: the baseband filter
    magnitude response evaluated at ``freq`` Hz."""
    if edge_hz <= 0:
        edge_hz = max(20.0, 0.02 * (high_hz - low_hz))
    h = np.ones(freq.shape[0])
    h *= np.clip((freq - (low_hz - edge_hz)) / edge_hz, 0.0, 1.0)
    h *= np.clip(((high_hz + edge_hz) - freq) / edge_hz, 0.0, 1.0)
    h = np.sin(0.5 * np.pi * h) ** 2  # raised-cosine edge
    if compensate_fqwin:
        # undo the mix1 erfc taper inside the passband, bounded at 40 dB,
        # and zero beyond 90% of the mix1 selection
        rel_frac = np.abs(freq) / geo.timf3_sampling_speed  # 0..0.5
        fq = fqwin_weight(rel_frac * geo.mix1_size, geo.mix1_size)
        h = h / np.maximum(fq, 1e-2)
        h *= rel_frac < 0.45
    for nf, nw in notches or ():
        d = np.abs(freq - nf)
        h *= np.where(d < nw, np.sin(0.5 * np.pi
                                     * np.clip(d / max(nw, 1e-9), 0, 1)
                                     ) ** 2, 1.0)
    if shape:
        pts = sorted((float(f), float(g)) for f, g in shape)
        fz = np.array([f for f, _ in pts])
        gz = np.array([g for _, g in pts])
        gain_db = np.interp(freq, fz, gz)
        h *= 10.0 ** (gain_db / 20.0)
    return h.astype(np.float32)


def bg_filter(geo: Geometry, low_hz: float, high_hz: float,
              edge_hz: float = 0.0, compensate_fqwin: bool = True,
              notches: tuple = (), shape: tuple = ()) -> np.ndarray:
    """Copy of linrad_tpu.ops.mix2.bg_filter: the baseband filter in
    shifted mix2-bin order (make_bg_filter, baseb_graph.c:1246)."""
    freq = _signed_bins(geo.mix2_size) * geo.timf3_sampling_speed \
        / geo.fft3_size
    return _filter_response(freq, geo, low_hz, high_hz, edge_hz,
                            compensate_fqwin, notches, shape)


@dataclass(frozen=True)
class Mix2Tables:
    filt: torch.Tensor  # (mix2_size,) float32 main filter
    syn: torch.Tensor   # (mix2_size,) float32 OLA synthesis weights

    @classmethod
    def create(cls, geo: Geometry, p: RxParams, device) -> "Mix2Tables":
        filt = bg_filter(geo, p.filter_low_hz, p.filter_high_hz,
                         notches=p.notches, shape=p.filter_shape)
        m2 = geo.mix2_size
        syn = synthesis_weights(m2, m2 - geo.mix2_new_points,
                                geo.fft3_sinpow)
        return cls(filt=torch.from_numpy(filt).to(device),
                   syn=torch.as_tensor(syn, dtype=torch.float32,
                                       device=device))


@dataclass
class Mix2State:
    ola_carry: torch.Tensor  # (mix2_interleave, C) complex64

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix2State":
        ov = geo.mix2_size - geo.mix2_new_points
        return cls(ola_carry=torch.zeros((ov, geo.channels),
                                         dtype=torch.complex64,
                                         device=device))


def mix2_step(geo: Geometry, tables: Mix2Tables, state: Mix2State,
              spectra: torch.Tensor) -> tuple[Mix2State, torch.Tensor]:
    """fft3 spectra (n3, fft3_size, C) -> filtered baseband
    (n3 * mix2_new_points, C) complex64 at baseband_sampling_speed."""
    m2 = geo.mix2_size
    n3 = geo.fft3_size
    bins = torch.remainder(signed_bins(m2, spectra.device), n3)
    sel = spectra.index_select(1, bins) * tables.filt[None, :, None]
    y = torch.fft.ifft(sel, dim=1) * (m2 / n3)
    baseb, carry = overlap_add(y * tables.syn[None, :, None],
                               geo.mix2_new_points, state.ola_carry)
    return Mix2State(ola_carry=carry), baseb
