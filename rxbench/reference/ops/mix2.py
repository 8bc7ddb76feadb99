"""Second mixer: baseband filter + inverse transform to demod input (port
of linrad_tpu/ops/mix2.py, reference mix2.c:146-262).

``mix2.size`` bins of each fft3 transform centred at DC are multiplied by
the user filter (with the inverse-``mix1_fqwin`` compensation,
baseb_graph.c:3795-3798), inverse transformed and overlap-added to the
baseband stream.  The carrier branch (the same bins times the narrow
``bg_carrfilter``, mix2.c:246-262) feeds coherent demodulation.  mixer_mode 2 replaces the main branch by a
decimating complex FIR straight on the timf3 stream (mix2.c:217-245); the
carrier branch still comes from fft3.

Every step function takes its streams as (..., S, C) and its state
stacked on the same leading axes, so one call serves one receiver or K
sub-receivers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from ..params import RxParams
from .framing import overlap_add
from .mix1 import _signed_bins, fqwin_weight, signed_bins
from .windows import synthesis_weights


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


def basebraw_fir(geo: Geometry, p: RxParams,
                 threshold: float = 1e-8) -> np.ndarray:
    """Copy of linrad_tpu.ops.mix2.basebraw_fir: complex FIR taps for the
    mixer_mode-2 time-domain path (baseb_graph.c:1540-1607): the inverse
    transform of the baseband filter, times the fft3 window, truncated
    where the taps fall below ``threshold`` of the centre tap.  The taps
    stay complex, so an asymmetric passband is realised exactly.

    Taps g[k] are applied as a correlation over a window of ``len(g)``
    timf3 samples centred on each output point."""
    n3 = geo.fft3_size
    fs3 = geo.timf3_sampling_speed
    freq = _signed_bins(n3) * fs3 / n3
    resp = _filter_response(freq, geo, p.filter_low_hz, p.filter_high_hz,
                            notches=p.notches, shape=p.filter_shape)
    # zero outside the decimated band (mix2 selection = baseband Nyquist)
    resp = resp * (np.abs(freq) < 0.5 * geo.baseband_sampling_speed)
    # correlation taps: g[k'] = (1/N) sum_b H[b] e^{-2pi i b k'/N}
    g = np.fft.ifft(resp.astype(np.complex128))
    kprime = np.arange(n3) - n3 // 2          # centred tap index
    taps = g[(-kprime) % n3]
    # fft3 window over the full span before truncation
    # (baseb_graph.c:1578-1583); ~1 near the centre where taps live
    taps = taps * np.sin(np.pi * (np.arange(n3) + 0.5) / n3) ** 2
    mag = np.abs(taps)
    keep = np.nonzero(mag > threshold * mag.max())[0]
    half = max(abs(int(keep[0]) - n3 // 2), abs(int(keep[-1]) - n3 // 2))
    half = min(half, n3 // 2 - 1)
    return taps[n3 // 2 - half:n3 // 2 + half + 1].astype(np.complex64)


@dataclass(frozen=True)
class Mix2Tables:
    filt: torch.Tensor       # (mix2_size,) float32 main filter
    carr_filt: torch.Tensor  # (mix2_size,) float32 narrow carrier filter
    syn: torch.Tensor        # (mix2_size,) float32 OLA synthesis weights
    fir: torch.Tensor | None = None  # mixer_mode-2 complex64 taps

    @classmethod
    def create(cls, geo: Geometry, p: RxParams, device,
               coh_factor: float = 8.0) -> "Mix2Tables":
        filt = bg_filter(geo, p.filter_low_hz, p.filter_high_hz,
                         notches=p.notches, shape=p.filter_shape)
        # carrier filter: bg.coh_factor x narrower, centred on the BFO
        # (mix2.c:246-262)
        width = (p.filter_high_hz - p.filter_low_hz) / (2.0 * coh_factor)
        carr = bg_filter(geo, -width, width)
        m2 = geo.mix2_size
        syn = synthesis_weights(m2, m2 - geo.mix2_new_points,
                                geo.fft3_sinpow)
        fir = (torch.from_numpy(basebraw_fir(geo, p)).to(device)
               if p.mixer_mode == 2 else None)
        return cls(filt=torch.from_numpy(filt).to(device),
                   carr_filt=torch.from_numpy(carr).to(device),
                   syn=torch.as_tensor(syn, dtype=torch.float32,
                                       device=device),
                   fir=fir)


@dataclass
class Mix2State:
    ola_carry: torch.Tensor       # (..., mix2_interleave, C) complex64
    carr_ola_carry: torch.Tensor  # the same for the carrier branch

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix2State":
        shape = (geo.mix2_size - geo.mix2_new_points, geo.channels)
        return cls(
            ola_carry=torch.zeros(shape, dtype=torch.complex64,
                                  device=device),
            carr_ola_carry=torch.zeros(shape, dtype=torch.complex64,
                                       device=device))


def _branch(geo: Geometry, spectra: torch.Tensor, filt: torch.Tensor,
            syn: torch.Tensor, carry: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    m2 = geo.mix2_size
    n3 = geo.fft3_size
    bins = torch.remainder(signed_bins(m2, spectra.device), n3)
    sel = spectra.index_select(-2, bins) * filt[:, None]
    y = torch.fft.ifft(sel, dim=-2) * (m2 / n3)
    return overlap_add(y * syn[:, None], geo.mix2_new_points, carry)


def mix2_step(geo: Geometry, tables: Mix2Tables, state: Mix2State,
              spectra: torch.Tensor, with_carrier: bool = False
              ) -> tuple[Mix2State, torch.Tensor, torch.Tensor | None]:
    """fft3 spectra (..., n3, fft3_size, C) -> filtered baseband.

    Returns (new_state, baseb, carrier): baseb (..., n3 * mix2_new_points,
    C) complex64 at baseband_sampling_speed; carrier the narrow
    carrier-filter branch of the same shape, or None."""
    baseb, carry = _branch(geo, spectra, tables.filt, tables.syn,
                           state.ola_carry)
    carrier = None
    carr_carry = state.carr_ola_carry
    if with_carrier:
        carrier, carr_carry = _branch(geo, spectra, tables.carr_filt,
                                      tables.syn, state.carr_ola_carry)
    return (Mix2State(ola_carry=carry, carr_ola_carry=carr_carry), baseb,
            carrier)


def mix2_carrier_step(geo: Geometry, tables: Mix2Tables, state: Mix2State,
                      spectra: torch.Tensor
                      ) -> tuple[Mix2State, torch.Tensor]:
    """The carrier branch alone, beside the mixer_mode-2 main path (the
    reference builds carr_tmp from fft3 in both mixer modes,
    mix2.c:246-262)."""
    carrier, carr_carry = _branch(geo, spectra, tables.carr_filt,
                                  tables.syn, state.carr_ola_carry)
    return (Mix2State(ola_carry=state.ola_carry, carr_ola_carry=carr_carry),
            carrier)


@dataclass
class Mix2FirState:
    carry: torch.Tensor  # (..., fir_len - 1, C) complex64 timf3 history

    @classmethod
    def create(cls, geo: Geometry, fir_len: int, device) -> "Mix2FirState":
        return cls(carry=torch.zeros((fir_len - 1, geo.channels),
                                     dtype=torch.complex64, device=device))


def mix2_fir_step(geo: Geometry, fir: torch.Tensor, state: Mix2FirState,
                  timf3: torch.Tensor) -> tuple[Mix2FirState, torch.Tensor]:
    """mixer_mode 2: decimating FIR straight on the timf3 stream
    (reference mix2.c:217-245).

    Output m correlates ``len(fir)`` timf3 samples starting at
    ``m * resamp`` against the taps; the stride ``resamp = fft3_size /
    mix2_size`` resamples timf3 to the baseband rate exactly as the
    frequency-domain path does.  The windows are an ``unfold`` view of the
    stream (no copy of M * len(fir) samples); the contraction is one
    complex product.  timf3 (..., S3, C) -> baseb (..., S3 // resamp, C)."""
    k = fir.shape[0]
    resamp = geo.fft3_size // geo.mix2_size
    xs = torch.cat([state.carry, timf3], dim=-2)
    m = timf3.shape[-2] // resamp
    win = xs.unfold(-2, k, resamp)            # (..., m, C, k), a view
    if win.shape[-3] != m:
        raise ValueError(f"mix2_fir_step: {timf3.shape[-2]} timf3 samples "
                         f"do not divide by the stride {resamp}")
    baseb = torch.matmul(win, fir)
    return (Mix2FirState(carry=xs[..., xs.shape[-2] - (k - 1):, :]),
            baseb)
