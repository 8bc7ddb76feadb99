"""Signal analysis: AM/PM noise sideband separation of a carrier
(port of linrad_tpu/weak/siganal.py, a copy; the input may be a torch
tensor on any device).

The reference's signal-analysis graph (``do_siganal``
siganal_graph.c:112-266) takes baseband segments containing a strong
carrier, rotates each segment so the average carrier lies on the real
axis, and transforms the relative fluctuations: the real part of the
spectrum's conjugate-symmetric component is amplitude noise (AN), the
antisymmetric component is phase noise (PN).  Segments whose carrier is
less than 90 % coherent (>10 % of power off DC) are skipped, exactly as
the reference does.  Used to characterise oscillator quality together
with the Allan-deviation analysis (viz.allan_deviation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.windows import make_window
from ..utils.host import to_numpy


@dataclass
class SigAnalResult:
    """Averaged AM/PM noise spectra of a carrier.

    an_power / pn_power: (fft_n//2, C) single-sided power spectra of the
    relative amplitude / phase fluctuations (bin i = offset
    i·fs/fft_n from the carrier; bin 0 holds the DC/residual term).
    Powers are relative to the carrier (multiply by the carrier power
    for absolute levels); dBc/Hz = 10·log10(p / enbw_hz).
    """

    an_power: np.ndarray
    pn_power: np.ndarray
    carrier_power: np.ndarray   # (C,) mean carrier power per channel
    segments_used: int
    segments_skipped: int
    an_corr: np.ndarray | None  # (fft_n//2,) cross-channel AN correlation
    pn_corr: np.ndarray | None

    def dbc(self, kind: str = "pn") -> np.ndarray:
        p = self.pn_power if kind == "pn" else self.an_power
        return 10.0 * np.log10(np.maximum(p, 1e-30))


def signal_analysis(baseb: np.ndarray, fft_n: int = 9,
                    sinpow: int = 2, purity: float = 0.9
                    ) -> SigAnalResult:
    """Analyse AM/PM noise of the carrier in ``baseb``.

    baseb: (S,) or (S, C) complex baseband containing a dominant
    carrier near DC (the reference reads d_baseb the same way,
    siganal_graph.c:125-133).  fft_n: log2 segment size (sg.fft_n).
    """
    x = to_numpy(baseb)
    if x.ndim == 1:
        x = x[:, None]
    size = 1 << fft_n
    c = x.shape[1]
    hop = size // 2 if sinpow > 0 else size
    nseg = max(0, (x.shape[0] - size) // hop + 1)
    win = make_window(size, sinpow).astype(np.float64)
    win /= np.sqrt(np.mean(win ** 2))  # unit noise bandwidth scale
    half = size // 2

    an_acc = np.zeros((half, c))
    pn_acc = np.zeros((half, c))
    an_spec = [[] for _ in range(c)]
    pn_spec = [[] for _ in range(c)]
    carr_acc = np.zeros(c)
    used = skipped = 0
    for s in range(nseg):
        seg = x[s * hop: s * hop + size, :].astype(np.complex128)
        # rotate the mean carrier onto the real axis and normalise
        # (siganal_graph.c:127-146)
        mean = seg.mean(axis=0)
        amp = np.abs(mean)
        if np.any(amp <= 0):
            skipped += 1
            continue
        rot = np.conj(mean / amp)
        rel = (seg * rot - amp) / amp            # AN = Re, PN = Im
        spec = np.fft.fft(rel * win[:, None], axis=0) / size
        # carrier coherence: the fluctuation spectrum is in units of
        # the carrier (=1); near-DC fluctuation power > 10 % means the
        # carrier drifted during the segment — skip and fold the small
        # residual back into the carrier otherwise
        # (siganal_graph.c:165-184: dt2 = 1 - Σ near-DC power,
        #  skip if dt2 < 0.9, then scale by dt2/sqrt(dt2))
        near = np.sum(np.abs(spec[:6]) ** 2, axis=0) + \
            np.sum(np.abs(spec[-5:]) ** 2, axis=0)
        coher = 1.0 - near
        if np.any(coher < purity):
            skipped += 1
            continue
        # symmetric/antisymmetric split: spectrum of the real part
        # (AN) and of the imaginary part (PN) (siganal_graph.c:149-160)
        idx = np.arange(half)
        mirror = (-idx) % size
        an = 0.5 * (spec[idx] + np.conj(spec[mirror])) * np.sqrt(coher)
        pn = 0.5 * (spec[idx] - np.conj(spec[mirror])) * np.sqrt(coher)
        an_acc += np.abs(an) ** 2
        pn_acc += np.abs(pn) ** 2
        for ch in range(c):
            an_spec[ch].append(an[:, ch])
            pn_spec[ch].append(pn[:, ch])
        carr_acc += amp ** 2
        used += 1

    if used == 0:
        return SigAnalResult(an_acc, pn_acc, carr_acc, 0, skipped,
                             None, None)
    an_corr = pn_corr = None
    if c == 2:
        # cross-channel correlation distinguishes common oscillator
        # noise from independent channel noise (sg_corr accumulation)
        a0 = np.array(an_spec[0])
        a1 = np.array(an_spec[1])
        p0 = np.array(pn_spec[0])
        p1 = np.array(pn_spec[1])

        def corr(u, v):
            num = np.abs(np.sum(u * np.conj(v), axis=0))
            den = np.sqrt(np.sum(np.abs(u) ** 2, axis=0)
                          * np.sum(np.abs(v) ** 2, axis=0)) + 1e-30
            return num / den
        an_corr = corr(a0, a1)
        pn_corr = corr(p0, p1)
    return SigAnalResult(an_acc / used, pn_acc / used, carr_acc / used,
                         used, skipped, an_corr, pn_corr)
