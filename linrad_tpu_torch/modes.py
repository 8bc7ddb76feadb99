"""Hardware/test analysis modes (port of linrad_tpu/modes.py, a copy;
the recordings may be torch tensors on any device).

Equivalents of the reference's in-program test modes (SURVEY.md §4.2):

- MODE_RX_ADTEST (adtest.c): input inspection — level statistics,
  clipping detection, DC offset, sample-value histogram.
- MODE_TXTEST / POWTIM (txtest.c, powtim.c, menu.c:412-574): spectrum
  analysis of one's own TX signal and power-vs-time measurement.
- The timing display's measured-sample-rate check (z_TIMING.txt) for
  recorded files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .utils.host import to_numpy


@dataclass
class ADTestResult:
    rms: float
    peak: float
    dc_i: float
    dc_q: float
    clip_fraction: float      # samples at >= 99% of full scale
    histogram: np.ndarray     # (bins,) of |sample| distribution
    image_rejection_db: float  # I/Q balance sanity (spectrum symmetry)


def adtest(iq: np.ndarray, full_scale: float = 1.0,
           bins: int = 64) -> ADTestResult:
    """Input inspection (adtest.c): run on any recorded block."""
    x = to_numpy(iq).reshape(-1)
    i, q = x.real, x.imag
    mag = np.abs(x)
    clip = float(np.mean(mag >= 0.99 * full_scale))
    hist, _ = np.histogram(mag, bins=bins, range=(0, full_scale))
    n = 1 << int(np.log2(max(len(x), 2)))
    spec = np.abs(np.fft.fft(x[:n] * np.hanning(n))) ** 2
    pos = spec[1: n // 2].sum()
    neg = spec[n // 2 + 1:].sum()
    rej = 10 * np.log10(max(pos, neg) / max(min(pos, neg), 1e-30))
    return ADTestResult(rms=float(np.sqrt(np.mean(mag ** 2))),
                        peak=float(mag.max()),
                        dc_i=float(i.mean()), dc_q=float(q.mean()),
                        clip_fraction=clip, histogram=hist,
                        image_rejection_db=float(rej))


@dataclass
class TXTestResult:
    spectrum_db: np.ndarray   # (n,) dB relative to carrier
    freqs_hz: np.ndarray
    carrier_hz: float
    imd3_db: float            # 3rd-order products vs carrier (two-tone)
    occupied_bw_hz: float     # 99% power bandwidth


def txtest(tx_iq: np.ndarray, fs: float, fft_n: int = 1 << 14
           ) -> TXTestResult:
    """TX signal analysis (txtest.c, menu.c:412-574)."""
    x = to_numpy(tx_iq).reshape(-1)
    n = min(fft_n, 1 << int(np.log2(len(x))))
    spec = np.abs(np.fft.fft(x[:n] * np.hanning(n))) ** 2
    spec = np.fft.fftshift(spec)
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1 / fs))
    k = int(np.argmax(spec))
    db = 10 * np.log10(np.maximum(spec / spec[k], 1e-30))
    # occupied bandwidth: central 99% of power
    c = np.cumsum(spec) / spec.sum()
    lo = int(np.searchsorted(c, 0.005))
    hi = int(np.searchsorted(c, 0.995))
    obw = float(freqs[min(hi, n - 1)] - freqs[lo])
    # IMD3: look for products at 2f1-f2 style offsets (two-tone test) —
    # report the strongest component outside 3x the occupied bandwidth
    mask = np.abs(freqs - freqs[k]) > max(1.5 * obw, 1.0)
    imd3 = float(db[mask].max()) if np.any(mask) else -200.0
    return TXTestResult(spectrum_db=db, freqs_hz=freqs,
                        carrier_hz=float(freqs[k]), imd3_db=imd3,
                        occupied_bw_hz=obw)


def powtim(iq: np.ndarray, fs: float, window_s: float = 0.01
           ) -> tuple[np.ndarray, np.ndarray]:
    """Power vs time (powtim.c, forced fft2 settings menu.c:517-529):
    returns (times_s, power) at window_s resolution."""
    x = to_numpy(iq).reshape(-1)
    w = max(1, int(window_s * fs))
    n = len(x) // w
    p = (np.abs(x[: n * w]) ** 2).reshape(n, w).mean(axis=1)
    return np.arange(n) * w / fs, p


def measure_sample_rate(n_samples: int, wall_seconds: float) -> float:
    """True-rate measurement analog (input_speed.c semantics): the
    reference continuously measures the real A/D rate against the system
    clock; for file processing this reports achieved throughput."""
    return n_samples / max(wall_seconds, 1e-12)
