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

Every device-to-host read made here is counted in ``host_reads``, and
its bytes in the tracer's ``d2h_bytes`` (the tuning's copies back in
``h2d_bytes``).  An update's spans (``utils/trace.py``): ``control.wait``
(a synchronise, only while device intervals are on, that takes the
device's wait out of the read), ``control.read`` (the spectrum's copy
out and its channel sum), ``control.afc`` (the AFC's numpy work),
``control.tune`` (the tuning's copies to the device) and
``control.spur`` (the spur scan, its reads included), inside which
``spur.read`` (the spectrum's copy out and its channel sum, the tuned
bin, and in the scan the four spur state tensors), ``spur.search`` (the
manager's numpy drop, re-centre and candidate search) and ``spur.write``
(the four tensors back to the device).  The manager's decisions are
counted in the tracer's ``spur_*`` counters and its active slots after
the latest scan in ``spur_slots``.  ``AFCTracker`` and ``SpurManager``
are numpy classes, this package's own copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Geometry
from ..params import RxParams
from ..utils import trace
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
        trace.watch("host_reads", self, "host_reads")
        if self.spur_manager is not None:
            trace.watch("spur_slots", self, "spur_slots")

    @property
    def spur_slots(self) -> int:
        """The spur manager's active slots after its latest scan."""
        m = self.spur_manager
        return 0 if m is None else len(m._age)

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
        scan = (self.spur_manager is not None and state.spur is not None
                and self.steps_done % self.spur_scan_interval == 0)
        if (self.afc is not None or scan) and trace.device_on() \
                and self.device.type == "cuda":
            with trace.span("control.wait"):
                torch.cuda.synchronize(self.device)
        if self.afc is not None:
            spec = out.fft2_power if geo.second_fft_enable else out.fft1_power
            with trace.span("control.read"):
                power = np.sum(spec.cpu().numpy(), axis=-1)
            trace.add("d2h_bytes", _nbytes(spec))
            self.host_reads += 1
            now = self.steps_done * self.step_seconds
            bins = frac = slope = None
            with trace.span("control.afc"):
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
                    else:
                        bins = self.afc.frame_bins(now + self.step_seconds, n)
            if bins is not None:
                with trace.span("control.tune"):
                    if frac is not None:
                        tune_frac = self._to_device(frac)
                        tune_slope = self._to_device(slope)
                    tune_bin = self._to_device(bins.astype(np.int64))
        if scan:
            with trace.span("control.spur"):
                spec = (out.fft2_power if geo.second_fft_enable
                        else out.fft1_avg_power)
                with trace.span("spur.read"):
                    avg = np.sum(spec.cpu().numpy(), axis=-1)
                    c = int(tune_bin.reshape(-1)[0])
                # the spectrum, the tuned bin, and the manager's read of
                # the four spur state tensors
                self.host_reads += 6
                new_spur = self.spur_manager.scan(avg, state.spur,
                                                  protect_lo=c - 7,
                                                  protect_hi=c + 7)
            trace.add("d2h_bytes", _nbytes(spec, tune_bin.reshape(-1)[:1],
                                           *_spur_leaves(state.spur)))
            trace.add("h2d_bytes", _nbytes(*_spur_leaves(new_spur)))
            state = dataclasses.replace(state, spur=new_spur)
        if with_frac:
            return tune_bin, tune_frac, tune_slope, state
        return tune_bin, state

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        trace.add("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(self.device)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _spur_leaves(spur) -> tuple:
    return spur.bins, spur.amp, spur.rot, spur.frac
