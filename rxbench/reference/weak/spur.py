"""Spur cancellation — coherent subtraction of stable narrow carriers
(port of linrad_tpu/weak/spur.py; reference ``eliminate_spurs`` spur.c:36,
``init_spur_elimination`` spursub.c:177, ``spur_removal`` wcw.c:204-248).

Each spur is a matched-filter estimate against the analysis-window
spectrum template around its bin, with a smoothed complex amplitude and a
tracked per-frame phase rotation: only components whose phase progresses
coherently build up a prediction, so noise and keyed signals are not
subtracted.  Estimation and subtraction run on the device over all frames
of the step at once (max_spurs * (2w+1) bins per frame); the spur *list*
(find, drop, re-centre) is host-side control at about 1 Hz
(:class:`SpurManager`, numpy, this package's own copy of the JAX
package's).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..geometry import Geometry
from ..ops.windows import make_window

MAX_SPURS = 16      # MAX_NO_OF_SPURS analog (fixed shape)
TEMPLATE_HALF = 3   # bins each side of the spur centre

# amplitude-smoothing window over frames (spur_speknum analog) and its
# shape: "sg", a quadratic Savitzky-Golay kernel, is a local least-squares
# fit like the reference's 11-transform LLSQ window (spur.c:517-578),
# unbiased for an envelope that varies quadratically.
SMOOTH_LEN = 11
SMOOTH_KIND = "sg"


def _smooth_kernel(k: int) -> np.ndarray:
    """Copy of linrad_tpu.weak.spur._smooth_kernel."""
    if SMOOTH_KIND == "flat" or k < 3:
        # a quadratic LLSQ needs >= 3 points; the flat kernel is the
        # least-squares fit below that anyway
        return np.full(k, 1.0 / k)
    if SMOOTH_KIND == "sg":
        x = np.arange(k) - k // 2
        a = np.vander(x, 3, increasing=True)       # [1, x, x^2]
        return (a @ np.linalg.inv(a.T @ a))[:, 0][::-1].copy()
    return np.hanning(k + 2)[1:-1]


TEMPLATE_OS = 64    # fractional-bin oversampling of the template


def window_template(size: int, sinpow: int) -> np.ndarray:
    """Copy of linrad_tpu.weak.spur.window_template: the analysis-window
    spectrum around DC, the shape a pure carrier takes in the fftx
    spectrum (unit centre)."""
    w = make_window(size, sinpow)
    spec = np.fft.fft(w)
    idx = np.arange(-TEMPLATE_HALF, TEMPLATE_HALF + 1)
    t = spec[idx % size]
    return (t / spec[0]).astype(np.complex64)


def window_template_table(size: int, sinpow: int,
                          os: int = TEMPLATE_OS) -> np.ndarray:
    """Copy of linrad_tpu.weak.spur.window_template_table: the oversampled
    analysis-window spectrum, the shape a carrier at ANY fractional bin
    offset takes across the surrounding bins (the reference's
    NO_OF_SPUR_SPECTRA=256 fractional template bank, init_spur_spectra
    spursub.c:824).

    Returns (2*(TEMPLATE_HALF+1)*os+1,) complex64: the window DTFT sampled
    every 1/os bin over offsets [-(H+1), +(H+1)] from the carrier,
    normalised so the on-bin centre is 1."""
    w = np.zeros(size * os, np.float64)
    w[:size] = make_window(size, sinpow)
    spec = np.fft.fft(w)
    h1 = TEMPLATE_HALF + 1
    idx = np.arange(-h1 * os, h1 * os + 1)
    t = spec[idx % (size * os)]
    return (t / spec[0]).astype(np.complex64)


@dataclass
class SpurState:
    bins: torch.Tensor  # (MAX_SPURS,) int32 — centre bin, -1 = inactive
    amp: torch.Tensor   # (MAX_SPURS, C) complex64 — smoothed amplitude
    rot: torch.Tensor   # (MAX_SPURS,) complex64 — per-frame phase step
    frac: torch.Tensor  # (MAX_SPURS,) float32 — fractional bin offset

    @classmethod
    def create(cls, geo: Geometry, device) -> "SpurState":
        return cls(
            bins=torch.full((MAX_SPURS,), -1, dtype=torch.int32,
                            device=device),
            amp=torch.zeros((MAX_SPURS, geo.channels), dtype=torch.complex64,
                            device=device),
            rot=torch.ones((MAX_SPURS,), dtype=torch.complex64,
                           device=device),
            frac=torch.zeros((MAX_SPURS,), dtype=torch.float32,
                             device=device))


@functools.lru_cache(maxsize=16)
def _smooth_tables(n_frames: int, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The smoothing kernel, flipped for a correlation, and the edge
    normaliser convolve(ones, kern, "same"), both float32 on the device.
    Cached: a step copies nothing from the host."""
    k = min(SMOOTH_LEN, n_frames)           # spur_speknum window
    if k % 2 == 0:
        k -= 1
    kern = _smooth_kernel(k).astype(np.float32)
    norm = np.convolve(np.ones(n_frames, np.float32), kern, mode="same")
    return (torch.from_numpy(kern[::-1].copy()).to(device),
            torch.from_numpy(norm.astype(np.float32)).to(device))


def _phasor(theta: torch.Tensor) -> torch.Tensor:
    """exp(i*theta) as complex64 from a float32 angle (a Python ``1j *``
    would promote through complex128)."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def spur_subtract_step(geo: Geometry, template: torch.Tensor,
                       state: SpurState, spectra: torch.Tensor,
                       gamma: float = 0.25, frac_gamma: float = 0.25,
                       refine_iters: int = 3
                       ) -> tuple[SpurState, torch.Tensor]:
    """Estimate and subtract all active spurs from a step of spectra.

    template: the oversampled window-spectrum table
    (:func:`window_template_table`); each spur's per-bin template is
    looked up at its tracked fractional offset, so mid-bin spurs subtract
    as deeply as on-bin ones.  The fractional offset is steered by the
    tracked per-frame rotation: a frequency offset of ``d`` bins advances
    the frame-to-frame phase by ``2*pi*d*hop/N`` (the PLL phase slope of
    refine_pll_parameters, spur.c:263).

    spectra: (n, N, C) complex64.  Returns (state, cleaned spectra).

    The model is fitted over the whole step at once: matched-filter
    estimates for all frames, a measured common per-hop rotation with a
    linear drift term, and a centred smoothing of the detrended amplitude
    (the reference's 11-transform least-squares window), iterated
    ``refine_iters`` times against the residual."""
    n_frames, big_n, c = spectra.shape
    dev = spectra.device
    th = TEMPLATE_HALF
    offs = torch.arange(-th, th + 1, device=dev)
    active = state.bins >= 0                                    # (S,)
    slot_bin = torch.where(active, state.bins, 0).to(torch.int64)
    idx = torch.remainder(slot_bin[:, None] + offs[None, :], big_n)
    hop = geo.fftx_new_points
    # phase advance per hop <-> fractional bins; unambiguous while
    # |frac| < big_n/(2*hop)
    bins_per_rad = big_n / (2.0 * math.pi * hop)
    # the tracked rotation carries the TOTAL per-hop advance
    # 2*pi*(b+frac)*hop/N; remove the integer-bin base rotation (for half
    # overlap the odd/even-bin sign the reference flips, spur.c:247)
    # before reading frac
    base_idx = torch.remainder(slot_bin * hop, big_n).to(torch.float32)
    base_rot = _phasor((2.0 * math.pi / big_n) * base_idx)
    os = TEMPLATE_OS
    centre = (th + 1) * os
    offs_f = offs.to(torch.float32)

    def templ(frac):
        """fractional templates: frac (..., S) -> (..., S, tlen)."""
        pos = (offs_f - frac[..., None]) * os + centre
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0,
                         template.shape[0] - 2)
        w = pos - i0
        return template[i0] * (1.0 - w) + template[i0 + 1] * w

    def matched(t, sel):
        """t (..., S, tlen), sel (n, S, tlen, C) -> estimates (n, S, C)."""
        tnorm = torch.clamp((t.abs() ** 2).sum(-1), min=1e-20)
        if t.dim() == 2:
            t = t[None]
            tnorm = tnorm[None]
        return (sel * t.conj()[:, :, :, None]).sum(2) / tnorm[:, :, None]

    def select(x):
        return x[:, idx, :]                           # (n, S, tlen, C)

    # first pass: step-start template, for the rotation/curvature fit
    est = matched(templ(state.frac), select(spectra))          # (n, S, C)

    # measured per-frame advances (power-weighted), relative to the
    # tracked rotation so angles stay small and unwrapped
    advf = (est[1:] * est[:-1].conj()).sum(2)                  # (n-1, S)
    adv = advf.sum(0)                                          # (S,)
    mag = adv.abs()
    meas = torch.where(mag > 1e-20, adv / torch.clamp(mag, min=1e-20),
                       torch.ones_like(adv))
    # the step-long measurement averages n_frames advances, so the blend
    # gain scales with the step (one long step ~ convergence)
    g = min(1.0, gamma * n_frames)
    blend = state.rot + g * (meas - state.rot)
    rot = torch.where(active, blend / torch.clamp(blend.abs(), min=1e-20),
                      state.rot)

    # second-order term: weighted linear fit of the advance residuals
    # against the frame index (the reference's phase curvature
    # spur_d2pha): a drifting spur advances its per-hop phase linearly
    dang = torch.angle(advf * rot.conj()[None, :])             # (n-1, S)
    wgt = advf.abs()                                           # (n-1, S)
    f_mid = torch.arange(n_frames - 1, dtype=torch.float32,
                         device=dev)[:, None]
    w0 = torch.clamp(wgt.sum(0), min=1e-20)
    fbar = (wgt * f_mid).sum(0) / w0
    dbar = (wgt * dang).sum(0) / w0
    varf = torch.clamp((wgt * (f_mid - fbar[None, :]) ** 2).sum(0),
                       min=1e-20)
    curv = (wgt * (f_mid - fbar[None, :])
            * (dang - dbar[None, :])).sum(0) / varf            # rad/hop^2
    curv = torch.where(active, curv, 0.0)

    # detrend with the quadratic phase model, smooth (centred), re-trend
    a0 = torch.angle(rot) + dbar - curv * fbar       # advance at frame 0
    fidx = torch.arange(n_frames, dtype=torch.float32, device=dev)[:, None]
    theta = a0[None, :] * fidx + 0.5 * curv[None, :] * fidx ** 2
    ph = _phasor(theta)                                        # (n, S)
    # carry the END-of-step advance, so the next step (and the frac
    # tracker) see the current frequency, not the step average
    rot = torch.where(active, _phasor(a0 + curv * (n_frames - 1)), rot)
    # second pass: per-frame fractional templates following the fitted
    # slope (the reference re-indexes spur_spectra every transform from
    # its PLL frequency, spur.c:177/296)
    slope_bins = torch.where(active, curv * bins_per_rad, 0.0)  # (S,)
    frac_f = state.frac[None, :] + slope_bins[None, :] * fidx   # (n, S)
    t = templ(frac_f)                                  # (n, S, tlen)
    kern, norm = _smooth_tables(n_frames, dev)
    half = kern.shape[0] // 2

    def smooth_all(x):
        """convolve(x, kern, "same") / norm along the frames of x
        (n, S, C) complex64: windows by ``unfold`` and a float32 sum, not
        ``conv1d``, which cuDNN may run in TF32."""
        pad = x.new_zeros((half,) + tuple(x.shape[1:]))
        win = torch.cat([pad, x, pad]).unfold(0, kern.shape[0], 1)
        return (win * kern).sum(-1) / norm[:, None, None]

    # Iterated refinement against the residual (the reference re-invokes
    # refine_pll_parameters on it, spur.c:371/383): each pass is one
    # matched filter, one smoothing and one scatter-add.
    #
    # The scatter accumulates, and stays deterministic: inactive slots all
    # point at bin 0 but add exact zeros, and the manager keeps active
    # spurs more than 2*TEMPLATE_HALF bins apart, so every element of
    # ``cleaned`` receives at most one non-zero term.  (Dropping the
    # inactive rows instead would need their count on the host: a
    # device-to-host wait inside the step.)
    frame = torch.arange(n_frames, device=dev)[:, None, None]
    dsm_tot = torch.zeros_like(est)                            # (n, S, C)
    cleaned = spectra.clone()
    cleaned_ri = torch.view_as_real(cleaned)
    for _ in range(max(1, refine_iters)):
        d = matched(t, select(cleaned)) * ph.conj()[:, :, None]  # (n, S, C)
        dsm = smooth_all(d)
        dsm_tot = dsm_tot + dsm
        pred = dsm * ph[:, :, None]                            # (n, S, C)
        sub = torch.where(active[None, :, None, None],
                          pred[:, :, None, :] * t[:, :, :, None], 0.0)
        cleaned_ri.index_put_((frame, idx[None]),
                              torch.view_as_real(-sub), accumulate=True)

    # state for the next step and the manager
    amp = torch.where(active[:, None], dsm_tot[-1] * ph[-1][:, None],
                      state.amp)
    frac_target = torch.angle(rot * base_rot.conj()) * bins_per_rad
    frac = torch.where(active,
                       state.frac + min(1.0, n_frames * frac_gamma)
                       * (frac_target - state.frac),
                       state.frac)
    return SpurState(bins=state.bins, amp=amp, rot=rot, frac=frac), cleaned


@dataclass
class SpurManager:
    """Host-side spur list control (the auto-search of spur.c), numpy.

    Finds persistent narrow peaks in the long-term averaged spectrum
    (outside the protected passband), assigns them to state slots and
    re-centres drifted spurs.  :meth:`scan` reads the four state tensors
    from the device once and writes them back."""

    geo: Geometry
    ston: float = 25.0          # power ratio over median to call a spur
    drop_after: int = 8         # scans of grace before fade checks
    _slots: dict = field(default_factory=dict)   # slot -> bin
    _age: dict = field(default_factory=dict)     # slot -> scans held

    def scan(self, avg_power: np.ndarray, state: SpurState,
             protect_lo: int = -1, protect_hi: int = -1) -> SpurState:
        p = np.asarray(avg_power, np.float64)
        n = len(p)
        med = np.median(p)
        dev = state.bins.device
        bins = state.bins.cpu().numpy().copy()
        amp = state.amp.cpu().numpy().copy()
        rot = state.rot.cpu().numpy().copy()
        frac = state.frac.cpu().numpy().copy()
        taken = set(int(b) for b in bins if b >= 0)
        # drop spurs whose TRACKED amplitude faded (avg_power is taken
        # after the subtraction, so a well-cancelled spur leaves no power
        # at its bin: the model amplitude is the evidence of life, like
        # spur_ampl vs spur_minston*spur_noise spur.c:372)
        for s in range(MAX_SPURS):
            b = int(bins[s])
            if b < 0:
                self._age.pop(s, None)
                continue
            self._age[s] = self._age.get(s, 0) + 1
            tracked = float(np.sum(np.abs(amp[s]) ** 2))
            if self._age[s] > self.drop_after and tracked < 3.0 * med:
                bins[s] = -1
                amp[s] = 0
                rot[s] = 1
                frac[s] = 0
                taken.discard(b)
                self._age.pop(s, None)
                continue
            # re-centre a drifted spur: once the tracked fractional offset
            # leaves the centre cell, move the integer bin and keep the
            # model phase-consistent (shift_spur_table spur.c:70-76)
            shift = int(np.round(frac[s]))
            if shift != 0:
                # rot tracks the PHYSICAL per-hop advance and is unaffected
                # by relabelling the centre bin; frac is measured against
                # the new bin's base rotation
                bins[s] = (b + shift) % n
                frac[s] -= shift
                taken.discard(b)
                taken.add(int(bins[s]))
        # find candidates: local maxima well above the floor, narrow
        cand = np.argsort(p)[::-1][:64]
        for b in cand:
            b = int(b)
            if p[b] < self.ston * med:
                break
            if protect_lo <= b <= protect_hi:
                continue
            if any(abs(b - t) <= 2 * TEMPLATE_HALF or
                   abs(b - t) >= n - 2 * TEMPLATE_HALF for t in taken):
                continue
            free = np.where(bins < 0)[0]
            if len(free) == 0:
                break
            s = int(free[0])
            bins[s] = b
            amp[s] = 0
            rot[s] = 1
            frac[s] = 0
            self._age[s] = 0
            taken.add(b)
        return SpurState(bins=torch.from_numpy(bins).to(dev),
                         amp=torch.from_numpy(amp).to(dev),
                         rot=torch.from_numpy(rot).to(dev),
                         frac=torch.from_numpy(frac).to(dev))
