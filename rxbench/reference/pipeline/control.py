"""Host-side weak-signal control (port of
linrad_tpu/pipeline/control.py).

The AFC runs at the step rate on the host, as in the JAX package: it
reads each step's fft2 power spectrum (one device-to-host copy per step),
acquires the signal from 4 steps of spectra, then tracks it, and steers
the next step's tuning.  With ``afc_coherent`` the tuning becomes a
constant base bin plus per-frame (frac, slope) ramps
(``AFCTracker.frame_tuning``), otherwise per-frame integer bins
(``frame_bins``).

The spur list is managed at about 1 Hz of signal time, not per N steps
(the step size is a batching knob): every ``spur_scan_interval`` steps
``SpurManager.scan`` reads the averaged spectrum, the tuned bin and the
four spur state tensors, and writes the new slots back.

Every device-to-host read made here is counted in ``host_reads``.
``AFCTracker`` and ``SpurManager`` are numpy classes, this package's own
copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Geometry
from ..params import RxParams
from ..weak.afc import AFCConfig, AFCTracker
from ..weak.spur import SpurManager


class WeakSignalControl:
    def __init__(self, geo: Geometry, params: RxParams, device):
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
        # the spur auto-search runs at the reference's ~Hz rate in signal
        # time (spursearch, spur.c): a fixed step count at large steps
        # would delay acquisition by tens of seconds
        self.spur_scan_interval = max(1, int(round(1.4 / self.step_seconds)))
        self.spur_manager = SpurManager(geo) if params.spur_enable else None

    def on_tune(self, freq_hz: float) -> None:
        if self.afc is not None:
            self.afc.status = 0
            self.afc.freq_hz = freq_hz % self.geo.timf1_sampling_speed
            self._afc_subbuf.clear()

    def update(self, out, tune_bin: torch.Tensor, state,
               tune_frac: torch.Tensor | None = None,
               tune_slope: torch.Tensor | None = None):
        """Advance the AFC and the spur manager by one step's outputs.

        Returns (new_tune_bin, new_state), or, when called with
        ``tune_frac``, (new_tune_bin, new_frac, new_slope, new_state).
        Once the AFC has a signal (status 2, 3 or 4) the tuning is
        per-frame tensors on the device; after a spur scan ``new_state``
        carries the manager's slots."""
        geo = self.geo
        with_frac = tune_frac is not None
        self.steps_done += 1
        if self.afc is not None:
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
                if with_frac and self.params.afc_coherent:
                    bins, frac, slope = self.afc.frame_tuning(
                        now + self.step_seconds, n)
                    tune_frac = torch.from_numpy(frac).to(self.device)
                    tune_slope = torch.from_numpy(slope).to(self.device)
                else:
                    bins = self.afc.frame_bins(now + self.step_seconds, n)
                tune_bin = torch.from_numpy(bins.astype(np.int64)).to(
                    self.device)
        if (self.spur_manager is not None and state.spur is not None
                and self.steps_done % self.spur_scan_interval == 0):
            spec = (out.fft2_power if geo.second_fft_enable
                    else out.fft1_avg_power)
            avg = np.sum(spec.cpu().numpy(), axis=-1)
            c = int(tune_bin.reshape(-1)[0])
            # the spectrum, the tuned bin, and the manager's read of the
            # four spur state tensors
            self.host_reads += 6
            new_spur = self.spur_manager.scan(avg, state.spur,
                                              protect_lo=c - 7,
                                              protect_hi=c + 7)
            state = dataclasses.replace(state, spur=new_spur)
        if with_frac:
            return tune_bin, tune_frac, tune_slope, state
        return tune_bin, state
