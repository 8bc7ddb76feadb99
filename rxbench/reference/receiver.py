"""The host loops the benchmark's entries drive, in plain form: a
receiver (the port's ``Receiver.tune`` and ``process_block`` without
graphs, resampler or hooks) and the tuning of a fleet's streams
(``FleetRunner.tune``), over this package's chain and control."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import derive_geometry
from .ops.blanker import BlankerTables
from .params import Demod, InputMode, RxParams
from .pipeline.chain import RxState, RxTables, make_rx_step
from .pipeline.control import WeakSignalControl


def make_params(fields: dict) -> RxParams:
    """RxParams from a configuration's fields (enums by value)."""
    f = dict(fields)
    if "input_mode" in f:
        f["input_mode"] = InputMode(f["input_mode"])
    if "demod" in f:
        f["demod"] = Demod(f["demod"])
    for key in ("notches", "filter_shape"):
        if key in f:
            f[key] = tuple(tuple(x) for x in f[key])
    return RxParams(**f)


def tensor_leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a tree of dataclasses, in field order (None fields
    left out)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for f in dataclasses.fields(tree)
            for t in tensor_leaves(getattr(tree, f.name))]


def with_leaves(template, leaves: list):
    """A tree shaped as ``template`` holding ``leaves`` (in the order of
    :func:`tensor_leaves`); each must match its leaf's shape and dtype."""
    old = tensor_leaves(template)
    if [(tuple(t.shape), t.dtype) for t in old] != \
            [(tuple(t.shape), t.dtype) for t in leaves]:
        raise ValueError("reference: a state of another structure")
    it = iter(leaves)

    def put(tree):
        if tree is None:
            return None
        if isinstance(tree, torch.Tensor):
            return next(it)
        return type(tree)(**{f.name: put(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})

    return put(template)


class PlainReceiver:
    """One receiver of ``params`` on ``device``: its own tables, state,
    step and weak-signal control."""

    def __init__(self, params: RxParams, device):
        self.device = torch.device(device)
        self.params = params
        self.geo = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device)
        ac = None
        if params.demod == Demod.COHERENT and params.coherent_mode == 1:
            ac = 2 * (1 if params.pol_adapt_enable else self.geo.channels)
        fir = self.tables.mix2.fir
        self.state = RxState.create(
            self.geo, self.device, spur=params.spur_enable,
            pol=params.pol_adapt_enable,
            fir_len=int(fir.shape[0]) if fir is not None else 0,
            audio_channels=ac)
        pulsewidth = (BlankerTables.create(self.geo, "cpu")[1]
                      if self.geo.second_fft_enable else 2)
        self.step = make_rx_step(self.geo, params,
                                 blanker_pulsewidth=pulsewidth,
                                 fractional_tune=True)
        self.tune_bin = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self.tune_frac = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
        self.tune_slope = None
        self.control = WeakSignalControl(self.geo, params, self.device)

    def tune(self, freq_hz: float) -> None:
        """The nearest fftx bin and the fractional-bin ramp."""
        n = self.geo.fftx_size
        t1 = freq_hz / self.geo.timf1_sampling_speed * n
        b = int(round(t1))
        self.tune_frac = torch.tensor(t1 - b, dtype=torch.float32,
                                      device=self.device)
        self.tune_bin = torch.tensor(b % n, dtype=torch.int64,
                                     device=self.device)
        self.tune_slope = None
        self.control.on_tune(freq_hz)

    def process_block(self, block: torch.Tensor):
        """One step on a (samples_per_step, C) complex64 block, then the
        control's update of the tuning."""
        self.state, out = self.step(self.tables, self.state, block,
                                    self.tune_bin, self.tune_frac,
                                    self.tune_slope)
        (self.tune_bin, self.tune_frac, self.tune_slope,
         self.state) = self.control.update(
            out, self.tune_bin, self.state, tune_frac=self.tune_frac,
            tune_slope=self.tune_slope)
        return out


def fleet_tuning(geo, freqs_hz) -> tuple[np.ndarray, np.ndarray]:
    """Per-stream (bins, fractions) of a fleet tuned to ``freqs_hz``."""
    n = geo.fftx_size
    t1 = np.asarray(freqs_hz, np.float64) / geo.timf1_sampling_speed * n
    bins = np.round(t1).astype(np.int64)
    return bins % n, (t1 - bins).astype(np.float32)
