"""Fleet mode: many independent receivers as one batched step (port of
linrad_tpu/parallel/fleet.py).

N dial frequencies, N antennas or N recordings at once are N Linrad
instances in the reference.  Here, as in the JAX package, they are one
program: the receive step is mapped over a leading stream axis with
``torch.func.vmap``, so every device operation of the step runs once for
all streams.  The fused fft1 kernel has a vmap rule of its own
(``ops/fused_fft1.py``) that folds the streams into its channel axis: one
launch per step for the whole fleet.  Per-stream state and tuning are
carried batched; the tables are shared.

The batched step is captured into a CUDA graph and replayed K times per
call, as :class:`..pipeline.batch.BatchRunner` replays the single step.
On ``device="cpu"`` it runs eagerly.  Over several devices, as the JAX
runner's ``devices=`` mesh, each device runs its own such runner on
n/d of the streams (no communication between them), and a call enqueues
their K replays in turns before it waits for any.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..pipeline.batch import BatchRunner, tensor_leaves
from ..pipeline.chain import RxOutputs, _map_tensors, make_rx_step
from ..pipeline.receiver import _pulsewidth


def _rebuild(template, leaves):
    """A tree shaped as ``template`` with ``leaves`` (in the order of
    :func:`tensor_leaves`) in place of its tensors."""
    it = iter(leaves)
    return _map_tensors(lambda _t: next(it), template)


def make_fleet_step(geo, params, blanker_pulsewidth: int, fields: tuple):
    """The receive step (fractional tuning on) mapped over a leading
    stream axis: ``step(tables, state, blocks, tune_bins, tune_fracs) ->
    (state, outputs)`` with state, blocks (R, S, C), tune_bins (R,) int64
    and tune_fracs (R,) float32 batched over R streams and the tables
    shared.  ``outputs`` holds the RxOutputs ``fields`` with the stream
    axis in front; the others are None."""
    step = make_rx_step(geo, params, blanker_pulsewidth=blanker_pulsewidth,
                        fractional_tune=True)
    empty = {f.name: None for f in dataclasses.fields(RxOutputs)}

    def fleet_step(tables, state, blocks, tune_bins, tune_fracs):
        def one(leaves, block, tune_bin, tune_frac):
            s, out = step(tables, _rebuild(state, leaves), block, tune_bin,
                          tune_frac)
            return tensor_leaves(s), tuple(getattr(out, f) for f in fields)

        leaves, outs = torch.func.vmap(one)(tensor_leaves(state), blocks,
                                            tune_bins, tune_fracs)
        return (_rebuild(state, leaves),
                RxOutputs(**{**empty, **dict(zip(fields, outs))}))

    return fleet_step


class FleetRunner(BatchRunner):
    """Process ``n_streams`` independent IQ streams in lockstep, K steps
    per call.

    Each stream has its own carried state and its own tune frequency; the
    parameters, geometry and tables are shared.  ``device`` is one device,
    or a list of them (the JAX runner's ``devices=`` mesh): over d devices
    each runs n_streams/d of the streams, stream order device-major, and
    n_streams must be a multiple of d.  ``recorded``:
    the caller's count of kernel calls recorded into CUDA graphs, as for
    :class:`..pipeline.batch.BatchRunner`."""

    def __init__(self, params, n_streams: int, k_steps: int = 8,
                 outputs: tuple = ("audio",), *, device="cuda",
                 recorded=None):
        devices = device if isinstance(device, (list, tuple)) else [device]
        self.n = int(n_streams)
        if self.n % len(devices):
            raise ValueError(f"FleetRunner: {self.n} streams do not split "
                             f"over {len(devices)} devices")
        self.parts = [self]
        if len(devices) > 1:
            self.parts = [FleetRunner(params, self.n // len(devices),
                                      k_steps, outputs, device=dev,
                                      recorded=recorded)
                          for dev in devices]
            first = self.parts[0]
            self.device, self.params, self.geo = (first.device, first.params,
                                                  first.geo)
            self.k, self.outputs, self.tables = (first.k, first.outputs,
                                                 first.tables)
            self.kernels_per_replay = sum(p.kernels_per_replay
                                          for p in self.parts)
            return
        self._setup(params, k_steps, outputs, None, devices[0], recorded)
        geo = self.geo
        if not geo.iq_input:
            raise ValueError("FleetRunner: IQ input only, as in the JAX "
                             "package")
        one = self._new_state()
        state = _map_tensors(
            lambda x: x[None].expand((self.n,) + tuple(x.shape)).clone(), one)
        step = make_fleet_step(geo, params, _pulsewidth(geo), self.outputs)
        self._tune_bins = torch.zeros(self.n, dtype=torch.int64,
                                      device=self.device)
        self._tune_fracs = torch.zeros(self.n, dtype=torch.float32,
                                       device=self.device)
        self._rows = geo.samples_per_step
        self._capture(step, state, (self.n, geo.samples_per_step,
                                    geo.channels), torch.complex64,
                      (self._tune_bins, self._tune_fracs))

    @property
    def state(self):
        """The carried state of every stream, stream axis in front (over
        several devices: a copy gathered onto the first one)."""
        if len(self.parts) == 1:
            return self.graphed.state
        leaves = [tensor_leaves(p.graphed.state) for p in self.parts]
        cat = [torch.cat([x.to(self.device) for x in group])
               for group in zip(*leaves)]
        return _rebuild(self.parts[0].graphed.state, cat)

    @property
    def kernel_launches(self) -> int:
        """Launches of the counted kernels made by the replays, over every
        device (``kernels_per_replay`` sums the devices' graphs)."""
        return sum(p.kernels_per_replay * p.graphed.replays
                   for p in self.parts)

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """iq (n_streams, T) or (n_streams, T, C) -> {field: (n_streams,
        T_out, C)}; trailing samples short of a K-step call are dropped.
        Over several devices each call is enqueued on every device before
        the host waits for any."""
        if len(self.parts) == 1:
            return super().process(iq)
        if iq.shape[0] != self.n:
            raise ValueError(f"FleetRunner: {iq.shape[0]} streams, expected "
                             f"{self.n}")
        m = self.n // len(self.parts)
        collected = [{f: [] for f in self.outputs} for _ in self.parts]
        calls = [p._calls(p._segments(iq[j * m:(j + 1) * m]), c)
                 for j, (p, c) in enumerate(zip(self.parts, collected))]
        for _ in itertools.zip_longest(*calls):
            pass
        return {f: np.concatenate([p._concat(c[f]) for p, c in
                                   zip(self.parts, collected)])
                for f in self.outputs}

    def tune(self, freqs_hz) -> None:
        """Per-stream tune frequencies (a scalar is every stream's): the
        nearest fftx bin and the fractional-bin ramp, as Receiver.tune."""
        f = np.broadcast_to(np.asarray(freqs_hz, np.float64), (self.n,))
        if len(self.parts) > 1:
            m = self.n // len(self.parts)
            for j, p in enumerate(self.parts):
                p.tune(f[j * m:(j + 1) * m])
            return
        n = self.geo.fftx_size
        t1 = f / self.geo.timf1_sampling_speed * n
        bins = np.round(t1).astype(np.int64)
        # written into the tensors the graph reads, not rebound
        self._tune_fracs.copy_(torch.from_numpy(
            (t1 - bins).astype(np.float32)))
        self._tune_bins.copy_(torch.from_numpy(bins % n))

    def _segments(self, iq: np.ndarray) -> list:
        """iq (n_streams, T) or (n_streams, T, C) -> per call (K, R, S, C)."""
        if iq.ndim == 2:
            iq = iq[:, :, None]
        if iq.shape[0] != self.n:
            raise ValueError(f"FleetRunner: {iq.shape[0]} streams, expected "
                             f"{self.n}")
        per = self.samples_per_call
        shape = (self.n, self.k) + tuple(self._blocks.shape[2:])
        return [np.moveaxis(iq[:, i * per:(i + 1) * per].reshape(shape),
                            0, 1)
                for i in range(iq.shape[1] // per)]

    def _concat(self, stacks: list) -> np.ndarray:
        """The calls' (K, R, S_f, C) stacks as (R, T_out, C)."""
        if not stacks:
            return np.zeros((self.n, 0, 1))
        return np.concatenate(
            [np.moveaxis(a, 0, 1).reshape(self.n, -1, a.shape[-1])
             for a in stacks], axis=1)
