"""AFC — automatic frequency control for drifting weak carriers (the
port's own copy of linrad_tpu/weak/afc.py, host-side numpy;
tests/test_torch_config.py holds the two trackers to the same trajectory).

TPU-native re-design of the reference AFC (``make_afc`` afc_graph.c:362,
``collect_initial_spectrum`` afcsub.c:34, ``make_afc_signoi``
afcsub.c:693, ``afc_eval_line``).  The per-signal state machine keeps
the reference's status codes (afc_graph.c:374-378):

    0 = first call, everything unknown
    1 = frequency set but no signal detected
    2 = signal detected, frequency + linear drift stored
    3 = tracking ok
    4 = signal lost, holding constant frequency
    1000 = AFC disabled, fixed frequency

The search works on averaged fftx power spectra (computed on device);
the initial acquisition searches a (frequency x drift) grid by shift-
and-add over sub-averages — the drift-line search of
collect_initial_spectrum — then tracking fits a polynomial of frequency
vs time over ``fit_points`` past measurements (AG_PARMS fit_points /
avgnum / delay, globdef.h:884-899) and extrapolates per-frame mixer
frequencies, which drive mix1's per-frame centre bins (the
``mix1_fq_mid[]`` contract, do_mix1_afc mix1.c:648).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry import Geometry
from ..utils.llsq import parabolic_peak, polyfit_drift


@dataclass
class AFCConfig:
    """The AG_PARMS surface (globdef.h:884-899) plus search bounds."""

    fit_points: int = 10          # ag.fit_points: history in the drift fit
    avgnum: int = 1               # ag.avgnum: spectra per eval point
    delay: int = 0                # ag.delay: extrapolation lead, in blocks
    window: int = 1               # ag.window: sin^N taper over the avgnum
    minston: float = 2.0          # ag.minston: S/N below which a point is
                                  # dropped from the fit (afc_graph.c)
    fit_degree: int = 2           # polynomial degree (freq vs time)
    search_hz: float = 200.0      # ag.search_range half-width
    track_hz: float = 30.0        # ag.lock_range half-width
    max_drift_hz_per_s: float = 5.0
    ston_acquire: float = 8.0     # linear S/N to declare a signal
    ston_lose: float = 2.0        # linear S/N below which it is lost
    lose_count: int = 5           # consecutive bad updates -> status 4


@dataclass
class AFCTracker:
    """Host-side per-signal tracker (one per mix1 channel)."""

    geo: Geometry
    config: AFCConfig = field(default_factory=AFCConfig)
    status: int = 0
    freq_hz: float = 0.0          # current best frequency estimate
    ston: float = 0.0
    afc_noise: float = 0.0        # make_afc_signoi outputs
    afc_maxval: float = 0.0
    _times: list = field(default_factory=list)
    _freqs: list = field(default_factory=list)
    _weights: list = field(default_factory=list)
    _evals: list = field(default_factory=list)   # (sigpwr, noise, avgn)
    _spectra: list = field(default_factory=list)  # avgnum spectrum ring
    _bad: int = 0

    # -- helpers --------------------------------------------------------
    def _bin_hz(self) -> float:
        return self.geo.timf1_sampling_speed / self.geo.fftx_size

    def _eval_point(self, power: np.ndarray, center_hz: float,
                    half_hz: float) -> tuple[float, float, float]:
        """One AFC evaluation point (make_ag_point afcsub.c:793-990):
        (freq_hz, sigpwr, noise) — sigpwr from a parabolic fit on the
        sqrt scale, noise from two side windows via the
        below-8x-lowest-average rule, minus the statistical noise bias
        ``noise/sqrt(avgnum)`` (afcsub.c:980, 1015)."""
        n = self.geo.fftx_size
        bw = self._bin_hz()
        c = int(round(center_hz / bw))
        h = max(4, int(round(half_hz / bw)))
        npts = 2 * h + 1
        nn_offset = int(2.5 * h) + npts        # afcsub.c:833
        sig = power[(c + np.arange(-h, h + 1)) % n]
        n1 = power[(c - nn_offset + np.arange(-h, h + 1)) % n]
        n2 = power[(c + nn_offset + np.arange(-h, h + 1)) % n]
        k = int(np.argmax(sig))
        if k == 0 or k == npts - 1:
            return float("nan"), -1.0, 1e-12   # failed (afcsub.c:925)
        off, amp = parabolic_peak(np.sqrt(sig[k - 1]), np.sqrt(sig[k]),
                                  np.sqrt(sig[k + 1]))
        sigpwr = float(amp) ** 2
        freq = (c - h + k + off) * bw
        # noise floor: avg of side points below 8x the lower side mean
        t1 = 8.0 * min(n1.mean(), n2.mean())
        both = np.concatenate([n1, n2])
        keep = both[both < t1]
        noise = (keep.mean() if keep.size > npts // 4 else t1 / 8.0)
        # subtract the probable statistical excess (afc_noisefac)
        noisefac = 1.0 / np.sqrt(max(self.config.avgnum, 1))
        sigpwr -= noise * noisefac
        if sigpwr <= 0:
            return freq, 0.0, 1e-12
        noise += 1e-6 * sigpwr
        return freq, sigpwr, float(noise)

    def _signoi(self) -> float:
        """S/N over the recent eval points (make_afc_signoi
        afcsub.c:693-790): afc_maxval/afc_noise with the reference's
        outlier rejection; 0 when no valid points."""
        ev = self._evals[-(self.config.fit_points
                           + self.config.avgnum):]
        valid = [(s, nz, a) for (s, nz, a) in ev if s > 0]
        if not valid:
            return 0.0
        t2 = 3.0 * np.mean([nz for _s, nz, _a in valid])
        noises = [nz for _s, nz, _a in valid if nz < t2]
        if not noises:
            return 0.0
        afc_noise = float(np.mean(noises))
        sigs = [s for s, _nz, _a in valid if s > 2.0 * afc_noise]
        if not sigs:
            return 0.0
        t1 = float(np.mean(sigs))
        t2 = min(10.0 * afc_noise, 0.25 * t1)
        strong = [s for s, nz, a in valid
                  if s > t2 and 0.5 * s > (np.sqrt(a) + 1.0) * nz]
        if not strong:
            return 0.0
        afc_maxval = float(np.mean(strong))
        self.afc_noise = afc_noise
        self.afc_maxval = afc_maxval
        return afc_maxval / max(afc_noise, 1e-30)

    def acquire(self, sub_spectra: np.ndarray, center_hz: float,
                dt_sub: float) -> None:
        """Initial (frequency x drift) search over sub-averaged spectra.

        sub_spectra: (k, fftx_size) power, k consecutive sub-averages
        spaced dt_sub seconds (the drift-line shift-and-add of
        collect_initial_spectrum, afcsub.c:34)."""
        n = self.geo.fftx_size
        bw = self._bin_hz()
        k = sub_spectra.shape[0]
        c = int(round(center_hz / bw))
        h = max(3, int(round(self.config.search_hz / bw)))
        max_shift = max(1, int(round(self.config.max_drift_hz_per_s
                                     * dt_sub * (k - 1) / bw)))
        best = (-1.0, 0.0, 0.0)  # (score, freq, drift_hz_s)
        for shift_total in range(-max_shift, max_shift + 1):
            acc = np.zeros(2 * h + 1)
            for j in range(k):
                s = int(round(shift_total * j / max(k - 1, 1)))
                idx = (c + s + np.arange(-h, h + 1)) % n
                acc += sub_spectra[j][idx]
            kk = int(np.argmax(acc))
            noise = np.median(acc)
            score = acc[kk] / max(noise, 1e-30)
            if score > best[0]:
                if 0 < kk < 2 * h:
                    off, _ = parabolic_peak(acc[kk - 1], acc[kk],
                                            acc[kk + 1])
                else:
                    off = 0.0
                freq = (c - h + kk + off) * bw
                drift = shift_total * bw / max(dt_sub * (k - 1), 1e-9)
                best = (score, freq, drift)
        self.ston = best[0]
        if best[0] >= self.config.ston_acquire:
            self.freq_hz = best[1]
            self.status = 2
            self._times.clear()
            self._freqs.clear()
            self._weights.clear()
            self._bad = 0
        else:
            self.status = 1

    def update(self, power: np.ndarray, time_s: float) -> None:
        """One tracking update from the step-averaged spectrum.

        Spectra accumulate into a sin^N-windowed boxcar of ``avgnum``
        (the afct_window average, afcsub.c:847-860); each completed
        average produces one eval point (make_ag_point), and the S/N
        decision uses make_afc_signoi over the eval history."""
        cfg = self.config
        if self.status in (0, 1):
            return  # needs acquire()
        self._spectra.append(np.asarray(power))
        if len(self._spectra) < max(cfg.avgnum, 1):
            return
        k = len(self._spectra)
        if cfg.window > 0 and k > 1:
            w = np.sin(np.pi * (np.arange(k) + 0.5) / k) ** cfg.window
        else:
            w = np.ones(k)
        avg = np.tensordot(w / w.sum(), np.stack(self._spectra), axes=1)
        self._spectra.clear()
        freq, sigpwr, noise = self._eval_point(avg, self.freq_hz,
                                               cfg.track_hz)
        self._evals.append((sigpwr, noise, max(cfg.avgnum, 1)))
        if len(self._evals) > cfg.fit_points + cfg.avgnum + 4:
            self._evals.pop(0)
        self.ston = self._signoi()
        point_ok = (sigpwr > 0 and np.isfinite(freq)
                    and sigpwr / noise >= cfg.minston)
        good = self.ston >= cfg.ston_lose and point_ok
        if good:
            self._bad = 0
            self._times.append(time_s)
            self._freqs.append(freq)
            self._weights.append(min(sigpwr / noise, 100.0))
            if len(self._times) > cfg.fit_points:
                self._times.pop(0)
                self._freqs.pop(0)
                self._weights.pop(0)
            if len(self._times) >= 3:
                self.status = 3
            # polynomial fit, evaluated at the latest time
            deg = min(cfg.fit_degree, len(self._times) - 1)
            t0 = self._times[-1]
            coef = polyfit_drift(np.array(self._times) - t0,
                                 np.array(self._freqs), deg,
                                 np.array(self._weights))
            self.freq_hz = float(coef[0])
            self._coef = coef
            self._t0 = t0
        else:
            self._bad += 1
            if self._bad >= cfg.lose_count and self.status == 3:
                self.status = 4  # hold last good frequency

    def predict(self, time_s: float) -> float:
        """Extrapolated frequency at an absolute time (afc_eval_line)."""
        if self.status in (3,) and hasattr(self, "_coef"):
            dt = np.clip(time_s - self._t0, 0.0, 5.0)
            return float(sum(c * dt ** k
                             for k, c in enumerate(self._coef)))
        return self.freq_hz

    def frame_bins(self, step_start_s: float, n_frames: int) -> np.ndarray:
        """Per-frame mix1 centre bins for the next step (mix1_fq_mid),
        extrapolated ``ag.delay`` blocks ahead of the evaluation time
        (the pipeline latency compensation of afc_eval_line)."""
        hop_s = self.geo.fftx_new_points / self.geo.timf1_sampling_speed
        bw = self._bin_hz()
        lead = self.config.delay * hop_s
        t = step_start_s + lead + hop_s * np.arange(n_frames)
        freqs = np.array([self.predict(ti) for ti in t])
        return (np.round(freqs / bw).astype(np.int64)
                % self.geo.fftx_size).astype(np.int32)

    def frame_tuning(self, step_start_s: float, n_frames: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-frame (bins, frac, slope) for coherent drift tracking:
        a CONSTANT base bin for the whole step with the full deviation
        on the fractional ramp, linearised within each frame
        (mix1_step's tune_frac/tune_slope — the do_mix1_afc capability,
        mix1.c:648, without inter-frame integer-bin steps breaking the
        overlap-add)."""
        hop_s = self.geo.fftx_new_points / self.geo.timf1_sampling_speed
        bw = self._bin_hz()
        lead = self.config.delay * hop_s
        # frequencies at frame midpoints, plus one ahead for the slope
        t = step_start_s + lead + hop_s * (np.arange(n_frames + 1) + 0.5)
        tbins = np.array([self.predict(ti) for ti in t]) / bw
        base = int(round(tbins[n_frames // 2]))
        bins = np.full(n_frames, base % self.geo.fftx_size, np.int32)
        frac = (tbins[:n_frames] - base).astype(np.float32)
        slope = np.diff(tbins).astype(np.float32)
        return bins, frac, slope
