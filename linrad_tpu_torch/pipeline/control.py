"""Host-side weak-signal control (port of the AFC half of
linrad_tpu/pipeline/control.py).

The AFC runs at the step rate on the host, as in the JAX package: it
reads each step's fft2 power spectrum (one device-to-host copy per step,
counted in ``host_reads``), acquires the signal from 4 steps of spectra,
then tracks it, and steers the next step's tuning.  With
``afc_coherent`` the tuning becomes a constant base bin plus per-frame
(frac, slope) ramps (``AFCTracker.frame_tuning``), otherwise per-frame
integer bins (``frame_bins``).  ``AFCTracker`` is ``weak.afc``'s numpy
class, this package's own copy of the JAX package's.

The spur half (``spur_enable``) is not ported: ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import Geometry
from ..params import RxParams
from ..weak.afc import AFCConfig, AFCTracker


class WeakSignalControl:
    def __init__(self, geo: Geometry, params: RxParams, device):
        if params.spur_enable:
            raise NotImplementedError("the spur manager is not ported; see "
                                      "ROADMAP queue 1 item 13")
        self.geo = geo
        self.params = params
        self.device = torch.device(device)
        self.step_seconds = geo.samples_per_step / geo.timf1_sampling_speed
        self.steps_done = 0
        self.host_reads = 0
        self.afc = None
        self._afc_subbuf: list = []
        if params.afc_enable:
            self.afc = AFCTracker(
                geo, AFCConfig(fit_points=params.afc_fit_points,
                               max_drift_hz_per_s=max(
                                   params.afc_max_drift_hz / 10.0, 0.5)))

    def on_tune(self, freq_hz: float) -> None:
        if self.afc is not None:
            self.afc.status = 0
            self.afc.freq_hz = freq_hz % self.geo.timf1_sampling_speed
            self._afc_subbuf.clear()

    def update(self, out, tune_bin: torch.Tensor, tune_frac: torch.Tensor,
               tune_slope: torch.Tensor | None):
        """Advance the AFC by one step's outputs.

        Returns the next step's (tune_bin, tune_frac, tune_slope).  Once
        the AFC has a signal (status 2, 3 or 4) they are per-frame
        tensors on the device."""
        geo = self.geo
        self.steps_done += 1
        if self.afc is None:
            return tune_bin, tune_frac, tune_slope
        spec = out.fft2_power if geo.second_fft_enable else out.fft1_power
        power = np.sum(spec.cpu().numpy(), axis=-1)
        self.host_reads += 1
        now = self.steps_done * self.step_seconds
        if self.afc.status in (0, 1):
            self._afc_subbuf.append(power)
            if len(self._afc_subbuf) >= 4:
                self.afc.acquire(np.stack(self._afc_subbuf),
                                 self.afc.freq_hz, self.step_seconds)
                self._afc_subbuf.clear()
        else:
            self.afc.update(power, now)
        if self.afc.status in (2, 3, 4):
            n = geo.fftx_frames_per_step
            if self.params.afc_coherent:
                bins, frac, slope = self.afc.frame_tuning(
                    now + self.step_seconds, n)
                tune_frac = torch.from_numpy(frac).to(self.device)
                tune_slope = torch.from_numpy(slope).to(self.device)
            else:
                bins = self.afc.frame_bins(now + self.step_seconds, n)
            tune_bin = torch.from_numpy(bins.astype(np.int64)).to(
                self.device)
        return tune_bin, tune_frac, tune_slope
