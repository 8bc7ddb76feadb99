"""Host-side receiver (port of linrad_tpu/pipeline/receiver.py:Receiver).

Owns the configuration, builds geometry, tables and state on one device,
and streams blocks through the step.  The host only slices input blocks
and hands back outputs; tuning is kept as device tensors (integer bin
plus fractional-bin ramp), so a retune changes no shape.

Not ported yet, and refused with NotImplementedError: the audio
resampler (``audio_out_rate``, ROADMAP queue 1 item 13), the AFC and spur
controllers, ``Transport``, watchdog/monitor and user hooks (ROADMAP
queue 1 item 12), and every configuration that
:func:`..pipeline.chain.check_supported` refuses.
"""

from __future__ import annotations

import numpy as np
import torch

from linrad_tpu.geometry import Geometry, derive_geometry
from linrad_tpu.params import RxParams

from ..ops.blanker import BlankerTables
from .chain import (RxOutputs, RxState, RxTables, check_supported,
                    make_rx_step)

_Q12 = "ROADMAP queue 1 item 12"


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Receiver: device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return dev


class Receiver:
    def __init__(self, params: RxParams, *, device,
                 calibration: dict | None = None,
                 audio_out_rate: float | None = None):
        """device: where tables, state and every step live ("cuda",
        "cuda:1", "cpu"); there is no default.  calibration: optional
        {'filtercorr': ...} (linrad_tpu.calibration)."""
        if audio_out_rate:
            raise NotImplementedError("audio_out_rate (the audio resampler) "
                                      "is not ported; see ROADMAP queue 1 "
                                      "item 13")
        check_supported(params)
        self.device = resolve_device(device)
        self.params = params
        self.geo: Geometry = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device,
                                      calibration)
        self.state = RxState.create(self.geo, self.device)
        self.blanker_pulsewidth = 2
        if self.geo.second_fft_enable:
            _, self.blanker_pulsewidth = BlankerTables.create(self.geo,
                                                              "cpu")
        self._step = make_rx_step(self.geo, params,
                                  blanker_pulsewidth=self.blanker_pulsewidth,
                                  fractional_tune=True)
        self._tune_bin = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._tune_frac = torch.zeros((), dtype=torch.float32,
                                      device=self.device)

    def add_hook(self, event: str, fn) -> None:
        raise NotImplementedError(f"user hooks are not ported; see {_Q12}")

    # ---- tuning -------------------------------------------------------
    def tune(self, freq_hz: float) -> None:
        """Select the mix1 centre frequency: the nearest fftx bin plus a
        fractional-bin phase ramp put the dial frequency exactly at DC
        (set_mix1_phases mix1.c:781-860)."""
        n = self.geo.fftx_size
        t1 = freq_hz / self.geo.timf1_sampling_speed * n
        bin_idx = int(round(t1))
        self._tune_frac = torch.tensor(t1 - bin_idx, dtype=torch.float32,
                                       device=self.device)
        self._tune_bin = torch.tensor(bin_idx % n, dtype=torch.int64,
                                      device=self.device)

    @property
    def tuned_hz(self) -> float:
        n = self.geo.fftx_size
        b = int(self._tune_bin)
        if b >= n // 2:
            b -= n
        return ((b + float(self._tune_frac))
                * self.geo.timf1_sampling_speed / n)

    # ---- streaming ----------------------------------------------------
    def process_block(self, block) -> RxOutputs:
        """Process one step of input: (samples_per_step, C) complex IQ, a
        numpy array or a tensor on any device."""
        block = torch.as_tensor(block).to(device=self.device,
                                          dtype=torch.complex64)
        if block.dim() == 1:
            block = block[:, None]
        expect = (self.geo.samples_per_step, self.geo.channels)
        if tuple(block.shape) != expect:
            raise ValueError(f"Receiver.process_block: block "
                             f"{tuple(block.shape)}, expected {expect}")
        self.state, out = self._step(self.tables, self.state, block,
                                     self._tune_bin, self._tune_frac)
        return out

    def run(self, iq: np.ndarray, *, transport=None, pace: bool = False,
            watchdog=None, monitor=None):
        """Stream a recording; yields RxOutputs per step and drops the
        final partial block (modesub.c:1022)."""
        if transport is not None or pace or watchdog is not None \
                or monitor is not None:
            raise NotImplementedError(f"Transport, real-time pacing, "
                                      f"watchdog and monitor are not ported; "
                                      f"see {_Q12}")
        if iq.ndim == 1:
            iq = iq[:, None]
        s = self.geo.samples_per_step
        for i in range(iq.shape[0] // s):
            yield self.process_block(iq[i * s:(i + 1) * s])
