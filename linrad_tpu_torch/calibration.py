"""Calibration: amplitude/phase response correction and I/Q balance (the
port's own copy of linrad_tpu/calibration.py, numpy only;
tests/test_torch_calibration.py holds the two bit-equal).

A re-design of the reference calibration subsystem
(calibrate.c / caliq.c / calsub.c; procedure notes z_CALIBRATE.txt):

1. **Amplitude+phase calibration** (``cal_filtercorr`` calibrate.c:376,
   ``final_filtercorr_init`` calibrate.c:50): a pulse generator feeds
   the antenna input; averaged pulse spectra measure the analog
   response H(f); the correction ``fft1_filtercorr = desired(f)/H(f)``
   makes the total response flat with linear phase.  Applied as the
   per-bin complex multiply in fft1_c (ops/fft1.py).

2. **I/Q balance calibration** (``contract_foldcorr``/``expand_foldcorr``
   caliq.c:40-150, ``write_iq_foldcorr`` caliq.c:152): direct-conversion
   gain/phase imbalance leaks a mirror image; the correction is the
   widely-linear per-bin operation  X'[k] = X[k] - c[k]*conj(X[-k]).
   The reference stores c compressed to ``bal_segments`` smooth segments
   (the contract/expand pair); here the same smoothing is a segment
   average + interpolation.

Persistence mirrors the reference's per-mode dsp_<mode>_corr /
dsp_<mode>_iqcorr files (z_CALIBRATE.txt:24-55) as .npz.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .geometry import Geometry


# ---------------------------------------------------------------------------
# amplitude / phase (filtercorr)
# ---------------------------------------------------------------------------

def measure_response(pulse_iq: np.ndarray, geo: Geometry,
                     threshold_rel: float = 0.3,
                     return_count: bool = False):
    """Estimate the system frequency response from a pulse-train
    recording (the cal_iqdata accumulation of calibrate.c).

    pulse_iq: (n, C) complex64 recording of the calibration pulse
    generator.  Pulses are located by envelope peaks, windows of
    fft1_size around each pulse are averaged coherently (aligned to the
    strongest sample, phase-normalised), and the averaged spectrum is
    the response estimate.  Returns (fft1_size, C) complex128."""
    x = np.asarray(pulse_iq)
    if x.ndim == 1:
        x = x[:, None]
    n, c = x.shape
    size = geo.fft1_size
    env = np.abs(x).sum(axis=1)
    thr = threshold_rel * env.max()
    resp = np.zeros((size, c), np.complex128)
    count = 0
    i = size
    while i < n - size:
        if env[i] > thr and env[i] == env[i - size // 4: i + size // 4].max():
            seg = x[i - size // 2: i + size // 2]
            spec = np.fft.fft(np.fft.ifftshift(seg, axes=0), axis=0)
            # normalise the phase so pulses average coherently — by the
            # FIRST channel's reference phasor for every channel, so the
            # inter-channel phase (what dual-polarization calibration
            # measures, calsub2.c:331-397) survives the average
            ref = spec[1, 0]
            ref /= max(abs(ref), 1e-30)
            resp += spec * np.conj(ref)
            count += 1
            i += size
        else:
            i += 1
    if count == 0:
        raise ValueError("no calibration pulses found")
    if return_count:
        return resp / count, count
    return resp / count


def make_filtercorr(response: np.ndarray, desired: np.ndarray | None = None,
                    max_boost: float = 10.0) -> np.ndarray:
    """filtercorr = desired / response with bounded gain
    (final_filtercorr_init, calibrate.c:50; the desired response is the
    target passband, z_CALIBRATE.txt:12-17)."""
    h = np.asarray(response, np.complex128)
    if h.ndim == 1:
        h = h[:, None]
    if desired is None:
        desired = np.ones(h.shape[0])
    mag = np.abs(h)
    ref = np.median(mag[mag > 0.01 * mag.max()])
    floor = ref / max_boost
    corr = desired[:, None] * ref / np.where(mag < floor, np.inf, h)
    corr[~np.isfinite(corr)] = 0.0
    return corr.astype(np.complex64)


# ---------------------------------------------------------------------------
# iterative interval calibration (calibrate.c accumulation loop + calsub2.c)
# ---------------------------------------------------------------------------

def _band_limited_pulse(spec: np.ndarray) -> np.ndarray:
    """compute_pulse (calsub2.c:263-288): zero fft_size/128 bins at both
    spectrum ends and around the IQ centre (where the averaged pulse
    spectrum has serious errors), then back-transform to the time-domain
    pulse."""
    n = len(spec)
    s128 = max(1, n // 128)
    s = spec.copy()
    s[:s128] = 0
    s[n // 2 - s128: n // 2 + s128] = 0
    s[n - s128:] = 0
    return np.fft.ifft(s)


_PULPTS = 8   # calsub2.c:290 "#define PULPTS 8"


def align_channel_phases(resp: np.ndarray, n_refine: int = 3
                         ) -> np.ndarray:
    """Two-channel relative-phase refinement (cal_update_ram's
    refine_cnt loop, calsub2.c:327-398): adjust the per-channel spectra
    so the averaged pulses have the same phase in both channels.

    The phase difference is measured on the PULPTS time samples each
    side of the pulse centre, weighted by their joint power, and split
    symmetrically between the channels (cal_buf4[...+1]+=t3,
    [...+3]-=t3)."""
    r = np.asarray(resp, np.complex128).copy()
    if r.ndim != 2 or r.shape[1] < 2:
        return r
    for _ in range(n_refine):
        p0 = _band_limited_pulse(r[:, 0])
        p1 = _band_limited_pulse(r[:, 1])
        idx = np.r_[len(p0) - _PULPTS: len(p0), 0:_PULPTS]
        a, b = p0[idx], p1[idx]
        w = np.abs(a) ** 2 + np.abs(b) ** 2
        d = np.angle(b) - np.angle(a)
        d = (d + np.pi) % (2 * np.pi) - np.pi
        t3 = float(np.sum(w * d) / max(np.sum(w), 1e-30)) / 2.0
        r[:, 0] *= np.exp(1j * t3)
        r[:, 1] *= np.exp(-1j * t3)
    return r


class CalAverager:
    """Iterative interval calibration.

    The reference calibrates live: the operator keeps the pulse
    generator running while calibrate.c accumulates every detected pulse
    into cal_buf4 and cal_update_ram (calsub2.c:291-460) re-derives the
    correction, iterating until the displayed fit stops changing
    (z_CALIBRATE.txt procedure).  This class is that loop as a stream
    consumer: ``feed`` successive recording intervals; each call
    pulse-count-weights the running coherent average, re-aligns the
    channel phases, and re-derives ``filtercorr``; ``delta`` is the
    relative change of the correction so scripts can stop on
    convergence.
    """

    def __init__(self, geo: Geometry, desired: np.ndarray | None = None,
                 max_boost: float = 10.0, threshold_rel: float = 0.3):
        self.geo = geo
        self.desired = desired
        self.max_boost = max_boost
        self.threshold_rel = threshold_rel
        self._acc: np.ndarray | None = None
        self.pulse_count = 0
        self.updates = 0
        self.delta = np.inf
        self._corr: np.ndarray | None = None

    def feed(self, pulse_iq: np.ndarray) -> np.ndarray:
        """Accumulate one recording interval; returns the refreshed
        filtercorr."""
        resp, count = measure_response(
            pulse_iq, self.geo, threshold_rel=self.threshold_rel,
            return_count=True)
        add = resp * count
        if self._acc is None:
            self._acc = add
        else:
            self._acc = self._acc + add
        self.pulse_count += count
        avg = self._acc / self.pulse_count
        if avg.shape[1] >= 2:
            avg = align_channel_phases(avg)
        corr = make_filtercorr(avg, self.desired, self.max_boost)
        if self._corr is not None:
            num = np.linalg.norm(corr - self._corr)
            den = max(np.linalg.norm(corr), 1e-30)
            self.delta = float(num / den)
        self._corr = corr
        self.updates += 1
        return corr

    @property
    def response(self) -> np.ndarray:
        if self._acc is None:
            raise ValueError("no intervals fed")
        avg = self._acc / self.pulse_count
        return align_channel_phases(avg) if avg.shape[1] >= 2 else avg

    @property
    def filtercorr(self) -> np.ndarray:
        if self._corr is None:
            raise ValueError("no intervals fed")
        return self._corr

    def converged(self, tol: float = 1e-3) -> bool:
        return self.updates >= 2 and self.delta < tol


# ---------------------------------------------------------------------------
# I/Q balance (foldcorr)
# ---------------------------------------------------------------------------

def estimate_iq_balance(iq: np.ndarray, geo: Geometry,
                        bal_segments: int = 8) -> np.ndarray:
    """Estimate the per-bin image-leakage coefficient c[k].

    For a gain/phase-imbalanced direct-conversion receiver,
    X[k] = S[k] + c[k]*conj(S[-k]); with uncorrelated spectrum content
    the leakage is  c[k] = E{X[k] X[-k]} / E{|X[-k]|^2}  (the
    correlation the reference accumulates in its iq calibration run,
    caliq.c).  Returns (fft1_size, C) complex64, smoothed to
    ``bal_segments`` segments like contract_foldcorr (caliq.c:81-150).
    """
    x = np.asarray(iq)
    if x.ndim == 1:
        x = x[:, None]
    size = geo.fft1_size
    c = x.shape[1]
    nfr = x.shape[0] // size
    frames = x[: nfr * size].reshape(nfr, size, c)
    win = np.hanning(size)[None, :, None]
    spec = np.fft.fft(frames * win, axis=1)
    mirror = np.conj(spec[:, (-np.arange(size)) % size, :])
    # with X[k] = a S[k] + b conj(S[-k]):
    #   E{X[k] X[-k]}        = a b (P_k + P_-k)
    #   E{|X[k]|^2+|X[-k]|^2} ~ |a|^2 (P_k + P_-k)
    # so c = b/conj(a) = E{X[k] X[-k]} / E{|X[k]|^2 + |X[-k]|^2}
    # (the symmetric leakage appears in both factors, hence the joint
    # normaliser — a plain /E{|X[-k]|^2} over-estimates c by 2)
    num = np.mean(spec * np.conj(mirror), axis=0)
    den = (np.mean(np.abs(spec) ** 2, axis=0)
           + np.mean(np.abs(mirror) ** 2, axis=0))
    cc = num / np.maximum(den, 1e-30)
    # segment smoothing (contracted representation)
    seg = max(1, size // bal_segments)
    out = np.empty_like(cc)
    for s in range(0, size, seg):
        out[s: s + seg] = cc[s: s + seg].mean(axis=0, keepdims=True)
    return out.astype(np.complex64)


def apply_iq_correction(spec: np.ndarray, c: np.ndarray) -> np.ndarray:
    """X'[k] = X[k] - c[k] * conj(X[-k])  (expand_foldcorr application).

    spec: (..., fft1_size, C); c: (fft1_size, C)."""
    size = c.shape[0]
    mirror = np.conj(spec[..., (-np.arange(size)) % size, :])
    return spec - c * mirror


def iq_imbalance(iq: np.ndarray, gain: float, phase_rad: float
                 ) -> np.ndarray:
    """Apply a synthetic I/Q gain+phase imbalance (test utility — the
    impairment the calibration corrects)."""
    i = np.real(iq)
    q = np.imag(iq)
    q2 = gain * (np.cos(phase_rad) * q + np.sin(phase_rad) * i)
    return (i + 1j * q2).astype(np.complex64)


# ---------------------------------------------------------------------------
# persistence (dsp_<mode>_corr analogs)
# ---------------------------------------------------------------------------

def save_calibration(path: str, filtercorr: np.ndarray | None = None,
                     iq_corr: np.ndarray | None = None) -> None:
    data = {}
    if filtercorr is not None:
        data["filtercorr"] = filtercorr
    if iq_corr is not None:
        data["iq_corr"] = iq_corr
    np.savez(path, **data)


def load_calibration(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# Per-mode calibration file set (z_CALIBRATE.txt:24-55): each user mode
# owns its own frequency-response and channel-balance files, and the
# documented workflow is "calibrate in one mode and then copy the file"
# to the other modes sharing the hardware setup.
CAL_MODES = ("wcw", "cw", "hsms", "ssb", "fm", "am", "qrss",
             "txtest", "test", "tune")


def mode_cal_path(dirpath: str, mode: str, iq: bool = False) -> str:
    """dsp_<mode>_corr / dsp_<mode>_iqcorr file naming
    (z_CALIBRATE.txt:27-55)."""
    if mode not in CAL_MODES:
        raise ValueError(f"unknown calibration mode {mode!r}")
    kind = "iqcorr" if iq else "corr"
    return os.path.join(dirpath, f"dsp_{mode}_{kind}.npz")


def save_mode_calibration(dirpath: str, mode: str,
                          filtercorr: np.ndarray | None = None,
                          iq_corr: np.ndarray | None = None) -> None:
    if filtercorr is not None:
        save_calibration(mode_cal_path(dirpath, mode),
                         filtercorr=filtercorr)
    if iq_corr is not None:
        save_calibration(mode_cal_path(dirpath, mode, iq=True),
                         iq_corr=iq_corr)


def load_mode_calibration(dirpath: str, mode: str) -> dict:
    """Returns whatever of {filtercorr, iq_corr} exists for the mode."""
    out: dict = {}
    p = mode_cal_path(dirpath, mode)
    if os.path.exists(p):
        out.update(load_calibration(p))
    p = mode_cal_path(dirpath, mode, iq=True)
    if os.path.exists(p):
        out.update(load_calibration(p))
    return out


def copy_mode_calibration(dirpath: str, src_mode: str,
                          dst_modes) -> None:
    """Share one mode's calibration with others (the documented
    copy-the-file workflow, z_CALIBRATE.txt:22-24)."""
    for dst in dst_modes:
        for iq in (False, True):
            src = mode_cal_path(dirpath, src_mode, iq=iq)
            if os.path.exists(src):
                shutil.copyfile(src, mode_cal_path(dirpath, dst, iq=iq))
