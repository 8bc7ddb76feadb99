"""Batch (multi-step) runner: K steps per dispatch (port of
linrad_tpu/pipeline/batch.py).

The streaming Receiver enqueues one step's few thousand small device
operations per block, and on a fast card the host's enqueueing, not the
card, sets the step time.  The JAX package rolls K steps into one
``lax.scan`` under one ``jit``; the counterpart on a CUDA device is a
CUDA graph.  :class:`GraphedStep` captures the step once, with its state,
its input block and its tuning at fixed addresses, and replays it: one
host operation per step instead of thousands, no host synchronisation in
between.  :class:`BatchRunner` feeds K blocks per call through it.

State chains through the replays exactly as it does across streamed
steps: the captured graph ends by copying every leaf of the new state
back over the state it read.  A replay runs the same kernels on the same
data as the eager step, so the results are equal bit for bit.

On a CUDA device nothing here gives way to the eager step: a capture that
fails raises.  On ``device="cpu"`` (the caller's explicit choice) the same
step body, state write-back included, runs eagerly each call.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..geometry import derive_geometry
from ..ops.fused_fft1 import fused_fft1
from ..params import RxParams
from .chain import RxState, RxTables, _map_tensors, make_rx_step
from .receiver import _pulsewidth, resolve_device


def tensor_leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a tree of dataclasses, in field order (None fields
    left out): the order ``convert.flatten`` names them in."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for f in dataclasses.fields(tree)
            for t in tensor_leaves(getattr(tree, f.name))]


class GraphedStep:
    """A step function captured into a CUDA graph, with everything the
    graph reads at fixed addresses.

    step:   ``step(tables, state, block, *args) -> (state, outputs)``,
            functional (it returns new state tensors) and free of host
            synchronisation.
    state:  the initial state; cloned into buffers this object owns.
    block_shape, block_dtype: one step's input.
    args:   tensors handed to every step after the block (the tuning);
            the graph reads them where they are, so the caller retunes by
            writing into them (``copy_``/``fill_``), never by rebinding.

    ``__call__(block=None)`` copies ``block`` into the static input when
    given, replays, and returns the step's outputs.  The output tensors
    belong to the graph's memory pool and the next replay overwrites them:
    copy what must be kept.  ``state`` is the static state; assigning to
    it copies leaf by leaf.  One step is captured whatever the caller's
    batch, so capture time and the graph's private memory do not grow
    with it.

    Before the capture the step runs ``warmup`` times on the capture
    stream, on a scratch copy of the state: the first use of the fused
    fft1 kernel on a stream copies its twiddle table from the host and
    zeroes its scratch, and the FFT plans are made at first use; none of
    that may happen inside a capture.

    On a CPU device there is no graph: each call runs the same body, the
    write-back of the state included, eagerly."""

    def __init__(self, step, tables, state, block_shape: tuple,
                 block_dtype: torch.dtype, args: tuple = (), *,
                 warmup: int = 3):
        self._step = step
        self._tables = tables
        self._args = tuple(args)
        self._state = _map_tensors(torch.clone, state)
        leaves = tensor_leaves(self._state)
        self.device = leaves[0].device
        self.block = torch.zeros(block_shape, dtype=block_dtype,
                                 device=self.device)
        self.replays = 0
        self.capture_seconds = 0.0
        self.graph = None
        self._outs = None
        if self.device.type == "cuda":
            self._capture(warmup)

    def _body(self):
        """One step from the static state and input, then the new state
        written back over the static one."""
        s, out = self._step(self._tables, self._state, self.block,
                            *self._args)
        old = tensor_leaves(self._state)
        new = tensor_leaves(s)
        if len(old) != len(new):
            raise RuntimeError("GraphedStep: the step changed the structure "
                               "of its state")
        # a new leaf that lives in the static state's memory (a field
        # handed through, or a view of one) is set aside first, so that no
        # write-back reads what another has just overwritten
        owned = {t.untyped_storage().data_ptr() for t in old}
        new = [n if n is o or n.untyped_storage().data_ptr() not in owned
               else n.clone() for o, n in zip(old, new)]
        for o, n in zip(old, new):
            if n is not o:
                o.copy_(n)
        return out

    def _capture(self, warmup: int) -> None:
        dev = self.device
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            s = self._state
            for _ in range(max(1, warmup)):
                s, _out = self._step(self._tables, s, self.block,
                                     *self._args)
        self.stream.synchronize()
        del s, _out
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self._outs = self._body()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value) -> None:
        old, new = tensor_leaves(self._state), tensor_leaves(value)
        if [(t.shape, t.dtype) for t in old] != [(t.shape, t.dtype)
                                                 for t in new]:
            raise ValueError("GraphedStep: a state of another structure")
        for o, n in zip(old, new):
            o.copy_(n)

    @property
    def outputs(self):
        """The outputs of the last call (graph-owned on a CUDA device)."""
        return self._outs

    def __call__(self, block: torch.Tensor | None = None):
        if block is not None:
            self.block.copy_(block.reshape(self.block.shape),
                             non_blocking=True)
        if self.graph is None:
            self._outs = self._body()
        else:
            self.graph.replay()
        self.replays += 1
        return self.outputs


class _Slot:
    """One call's host buffers in page-locked memory, and the event that
    says the copies into and out of them have finished."""

    def __init__(self, blocks: torch.Tensor, stacks: dict):
        self.inp = torch.empty(blocks.shape, dtype=blocks.dtype,
                               pin_memory=True)
        self.out = {f: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for f, v in stacks.items()}
        self.done = torch.cuda.Event()
        self.busy = False


class BatchRunner:
    """Process K steps per call.

    outputs: which RxOutputs fields to collect across steps (big spectra
    fields cost memory when stacked K-deep; default collects the audio
    and baseband streams).  Like the JAX runner it runs the step without
    the fractional-bin tuning ramp and without the weak-signal control.

    On a CUDA device a call is one copy of K blocks from page-locked host
    memory, K replays of the captured step with a device copy of block i
    in and of the collected fields out around each, and one copy of the
    K-deep stacks back: 1 + F + K (2 + F) host operations for F collected
    fields, no synchronisation between the steps.  Two sets of host buffers
    alternate, so the host converts call i+1 while the card runs call i;
    a buffer is refilled only after the event behind its copies.

    A replay launches the fused fft1 kernel without a call of its wrapper,
    so the runner keeps the count: ``kernel_launches`` is the wrapper calls
    recorded into the graph times the replays made."""

    def __init__(self, params: RxParams, k_steps: int = 16,
                 outputs: tuple = ("audio", "baseb"),
                 calibration: dict | None = None, *, device="cuda"):
        self._setup(params, k_steps, outputs, calibration, device)
        step = make_rx_step(self.geo, params,
                            blanker_pulsewidth=_pulsewidth(self.geo))
        self._tune_bin = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        geo = self.geo
        if geo.iq_input:
            shape, dtype = (geo.samples_per_step, geo.channels), \
                torch.complex64
        else:
            shape, dtype = (2 * geo.samples_per_step, geo.channels), \
                torch.float32
        self._rows = shape[0]
        self._capture(step, self._new_state(), shape, dtype,
                      (self._tune_bin,))

    def _setup(self, params, k_steps, outputs, calibration, device) -> None:
        """Device, geometry and tables."""
        self.device = resolve_device(device)
        self.params = params
        self.geo = derive_geometry(params)
        self.k = int(k_steps)
        self.outputs = tuple(outputs)
        self.tables = RxTables.create(self.geo, params, self.device,
                                      calibration)

    def _new_state(self) -> RxState:
        """The state of one receiver at its start."""
        fir = self.tables.mix2.fir
        return RxState.create(
            self.geo, self.device, spur=self.params.spur_enable,
            pol=self.params.pol_adapt_enable,
            fir_len=int(fir.shape[0]) if fir is not None else 0)

    def _capture(self, step, state, shape: tuple, dtype: torch.dtype,
                 args: tuple) -> None:
        """The step as a GraphedStep on one step's input (shape, dtype),
        the K-deep input and output stacks on the device, and the host
        buffers."""
        recorded = fused_fft1.captured
        self.graphed = GraphedStep(step, self.tables, state, shape, dtype,
                                   args)
        self.kernels_per_replay = fused_fft1.captured - recorded
        self._blocks = torch.zeros((self.k, *shape), dtype=dtype,
                                   device=self.device)
        self._stacks = None
        self._slots = None
        if self.device.type == "cuda":
            self._make_stacks(self.graphed.outputs)
            self._slots = [_Slot(self._blocks, self._stacks)
                           for _ in range(2)]

    def _make_stacks(self, out) -> None:
        """The K-deep device stacks of the collected fields."""
        self._stacks = {
            f: torch.empty((self.k, *getattr(out, f).shape),
                           dtype=getattr(out, f).dtype, device=self.device)
            for f in self.outputs}

    @property
    def state(self) -> RxState:
        return self.graphed.state

    @property
    def kernel_launches(self) -> int:
        """fused_fft1 launches made by this runner's replays."""
        return self.kernels_per_replay * self.graphed.replays

    def tune(self, freq_hz: float) -> None:
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        # written into the tensor the graph reads, not rebound
        self._tune_bin.fill_(int(round(freq_hz / fs * n)) % n)

    @property
    def samples_per_call(self) -> int:
        return self.k * self.geo.samples_per_step

    def _run_call(self) -> None:
        """K steps over self._blocks into self._stacks."""
        for i in range(self.k):
            out = self.graphed(self._blocks[i])
            if self._stacks is None:
                self._make_stacks(out)
            for f in self.outputs:
                self._stacks[f][i].copy_(getattr(out, f))

    def _collect(self, source: dict, collected: dict) -> None:
        for f in self.outputs:
            collected[f].append(source[f].numpy().copy())   # (K, ...)

    def _segments(self, iq: np.ndarray) -> list:
        """The input of each call, shaped as the K-deep input stack."""
        if iq.ndim == 1:
            iq = iq[:, None]
        per = self.k * self._rows
        return [iq[i * per:(i + 1) * per].reshape(self._blocks.shape)
                for i in range(iq.shape[0] // per)]

    def _concat(self, stacks: list) -> np.ndarray:
        """The calls' (K, S_f, C) stacks of one field as one stream."""
        if not stacks:
            return np.zeros((0, 1))
        return np.concatenate([a.reshape(-1, a.shape[-1]) for a in stacks])

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """Process a recording; returns concatenated output streams.
        Trailing samples short of a full K-step call are dropped."""
        segments = self._segments(iq)
        n_calls = len(segments)
        collected: dict[str, list] = {f: [] for f in self.outputs}

        def drain(slot: _Slot) -> None:
            if slot.busy:
                slot.done.synchronize()
                self._collect(slot.out, collected)
                slot.busy = False

        for i, seg in enumerate(segments):
            if self._slots is None:             # the CPU: no staging
                self._blocks.copy_(torch.from_numpy(np.ascontiguousarray(seg)))
                self._run_call()
                self._collect(self._stacks, collected)
                continue
            slot = self._slots[i % 2]
            drain(slot)                         # call i-2 has left it
            slot.inp.numpy()[...] = seg
            self._blocks.copy_(slot.inp, non_blocking=True)
            self._run_call()
            for f in self.outputs:
                slot.out[f].copy_(self._stacks[f], non_blocking=True)
            slot.done.record()
            slot.busy = True
        if self._slots is not None:
            drain(self._slots[n_calls % 2])
            drain(self._slots[(n_calls + 1) % 2])
        return {f: self._concat(v) for f, v in collected.items()}
