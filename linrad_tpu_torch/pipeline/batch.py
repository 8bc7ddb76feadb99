"""Batch (multi-step) runner: K steps per dispatch (port of
linrad_tpu/pipeline/batch.py).

The streaming Receiver enqueues one step's few thousand small device
operations per block, and on a fast card the host's enqueueing, not the
card, sets the step time.  The JAX package rolls K steps into one
``lax.scan`` under one ``jit``; the counterpart on a CUDA device is a
CUDA graph.  :class:`GraphedStep` captures the step once, with its state,
its input block and its tuning at fixed addresses, and replays it: one
host operation per step instead of thousands, no host synchronisation in
between.  :class:`BatchRunner` feeds K blocks per call through it; the
receivers of :mod:`.receiver` and :mod:`..parallel.sharded` replay one
step per block, one graph per tuning structure over shared buffers.

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
from typing import Callable

import numpy as np
import torch

from ..geometry import derive_geometry
from ..params import RxParams
from ..utils import trace
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


def assign_leaves(static, value, what: str = "state") -> None:
    """Copy every leaf of the tree ``value`` into the same leaf of the tree
    ``static``, but those that are already the static tensor (compared by
    identity).  A tree of another structure, or a leaf of another shape
    or dtype, raises ValueError."""
    old, new = tensor_leaves(static), tensor_leaves(value)
    if [(t.shape, t.dtype) for t in old] != [(t.shape, t.dtype)
                                             for t in new]:
        raise ValueError(f"GraphedStep: {what} of another structure")
    for o, n in zip(old, new):
        if n is not o:
            o.copy_(n)


class GraphedStep:
    """A step function captured into a CUDA graph, with everything the
    graph reads at fixed addresses.

    step:   ``step(tables, state, block, *args) -> (state, outputs)``,
            functional (it returns new state tensors) and free of host
            synchronisation.
    state:  the initial state, any tree of dataclasses of tensors; cloned
            into buffers this object owns.
    block_shape, block_dtype: one step's input: a shape, or a list of
            shapes for a step that takes a list of tensors (the sharded
            steps' per-shard rows).
    args:   tensors handed to every step after the block (the tuning);
            the graph reads them where they are, so the caller retunes by
            writing into them (``copy_``/``fill_``), never by rebinding.
    share:  another GraphedStep whose tables, state and input buffers this
            one reads and writes instead of cloning its own: several graphs
            of one receiver (one per tuning structure) over one state.
            Each graph keeps its own private memory pool, so they may
            replay in any order.
    recorded: a running count of kernel calls recorded into CUDA graphs
            (``lambda: fused_fft1.captured``), read around the capture:
            ``kernels`` is the difference, the counted kernels one replay
            launches (0 without it, and on the CPU).

    ``__call__(block=None)`` copies ``block`` into the static input when
    given, replays, and returns the step's outputs.  The output tensors
    belong to the graph's memory pool and the next replay overwrites them:
    copy what must be kept.  ``state`` and ``tables`` are the static
    buffers; assigning to either copies the leaves that are not already
    the static ones (compared by identity), so handing back the state as
    it was read copies nothing.  One step is captured whatever the
    caller's batch, so capture time and the graph's private memory do not
    grow with it.

    Before the capture the step runs ``warmup`` times on the capture
    stream, on a scratch copy of the state: the first use of the fused
    fft1 kernel on a stream copies its twiddle table from the host and
    zeroes its scratch, and the FFT plans and cached device tables are
    made at first use; none of that may happen inside a capture.  The
    warm-up and the capture are the tracer's set-up spans
    ``graph.warmup`` and ``graph.capture`` (``utils/trace.py``), under
    the block id ``trace_id``.  The graph carries no timing event.

    While the tracer's device intervals are on, a call replays one of
    the step's two stage-timed twins instead, in turns: the same body
    captured again, at the first such call and on the calling thread,
    each into a graph of its own (its own memory pool, this step's
    tables, state and input) that records a timing-event pair at each
    stage of the step, so that each replay gives every stage's device
    time.  Two, so that a replay's events are read after the next
    replay has been enqueued (``trace.after_replay``), while the device
    works, and not while it waits for the host: a replay records its
    twin's events anew.  Each twin's warm-up of one step and its capture
    are a set-up span ``graph.timed_capture``.  A twin replay runs the
    same kernels on the same data, so its outputs and state are the
    graph's bit for bit; ``outputs`` are the twin's after it.  A step
    that records no stage keeps no twin (``timed_stages`` empty) and
    replays its graph.  The twins are kept, for the next time tracing is
    on, until this object is freed; ``kernels`` counts the graph's
    kernels, and a twin's capture adds to the recorded calls as any
    capture does.  Each call is a device interval ``graph.replay`` then.

    On a CPU device there is no graph: each call runs the same body, the
    write-back of the state included, eagerly."""

    def __init__(self, step, tables, state, block_shape,
                 block_dtype: torch.dtype, args: tuple = (), *,
                 warmup: int = 3, share: "GraphedStep | None" = None,
                 recorded: Callable[[], int] | None = None):
        self._step = step
        self._args = tuple(args)
        if share is None:
            self._tables = tables
            self._state = _map_tensors(torch.clone, state)
            self.device = tensor_leaves(self._state)[0].device
            if isinstance(block_shape, list):
                self.block = [torch.zeros(sh, dtype=block_dtype,
                                          device=self.device)
                              for sh in block_shape]
            else:
                self.block = torch.zeros(block_shape, dtype=block_dtype,
                                         device=self.device)
        else:
            self._tables, self._state = share._tables, share._state
            self.device, self.block = share.device, share.block
        self.replays = 0
        self.kernels = 0
        self.trace_id = trace.next_id()
        trace.watch("graph_replays", self, "replays")
        self.graph = None
        self._outs = None
        self._graph_outs = None
        self._twins = None      # two _TimedTwin, or False: no stage
        self._turn = 0          # the twin the next timed call replays
        if self.device.type == "cuda":
            self._capture(warmup, recorded or (lambda: 0))

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

    def _capture(self, warmup: int, recorded: Callable[[], int]) -> None:
        dev = self.device
        self.stream = torch.cuda.Stream(dev)
        with trace.setup("graph.warmup", self.trace_id):
            self._warm(warmup)
        with trace.setup("graph.capture", self.trace_id):
            before = recorded()
            self.graph = torch.cuda.CUDAGraph()
            with trace.capturing():
                with torch.cuda.graph(self.graph, stream=self.stream):
                    self._outs = self._graph_outs = self._body()
            torch.cuda.synchronize(dev)
            self.kernels = recorded() - before

    def _warm(self, steps: int) -> None:
        """``steps`` steps on the capture stream from a scratch copy of the
        state chain (the static state is read, never written)."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with trace.capturing(), torch.cuda.stream(self.stream):
            s = self._state
            for _ in range(max(1, steps)):
                s, _out = self._step(self._tables, s, self.block,
                                     *self._args)
        self.stream.synchronize()

    def _capture_twin(self):
        """A stage-timed twin (see the class), or False where the step
        records no stage."""
        with trace.setup("graph.timed_capture", self.trace_id):
            self._warm(1)
            graph = torch.cuda.CUDAGraph()
            with trace.capturing(timed=True) as stages:
                with torch.cuda.graph(graph, stream=self.stream):
                    outs = self._body()
            torch.cuda.synchronize(self.device)
        return _TimedTwin(graph, stages, outs, self.device) if stages \
            else False

    def _capture_twins(self):
        """The two stage-timed twins, or False where the step records no
        stage."""
        first = self._capture_twin()
        return first and (first, self._capture_twin())

    @property
    def timed_stages(self) -> list | None:
        """The stages the stage-timed twins time, in step order (empty
        where the step records none); None until a call with device
        intervals on has captured them."""
        if self._twins is None:
            return None
        return [name for name, _a, _b in self._twins[0].stages] \
            if self._twins else []

    @property
    def args(self) -> tuple:
        """The tensors the graph reads after the block (the tuning)."""
        return self._args

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value) -> None:
        assign_leaves(self._state, value, "state")

    @property
    def tables(self):
        return self._tables

    @tables.setter
    def tables(self, value) -> None:
        assign_leaves(self._tables, value, "tables")

    @property
    def outputs(self):
        """The outputs of the last call (graph-owned on a CUDA device)."""
        return self._outs

    def _load(self, block) -> None:
        """``block`` (a tensor, or a list of them) into the static input."""
        if isinstance(block, (list, tuple)):
            for dst, src in zip(self.block, block, strict=True):
                dst.copy_(src.reshape(dst.shape), non_blocking=True)
        elif block is not None:
            self.block.copy_(block.reshape(self.block.shape),
                             non_blocking=True)

    def __call__(self, block=None):
        if trace.device_on() and self.graph is not None:
            return self._timed_call(block)
        self._load(block)
        if self.graph is None:
            self._outs = self._body()
        else:
            self.graph.replay()
            self._outs = self._graph_outs
        self.replays += 1
        return self._outs

    def _timed_call(self, block):
        """A call while device intervals are on: a twin's replay, in
        turns (the graph's where the step has no stage), as a
        ``graph.replay`` interval; then the completed readings."""
        if self._twins is None:
            self._twins = self._capture_twins()
        twin = self._twins[self._turn] if self._twins else None
        if twin is not None:
            self._turn ^= 1
            trace.before_replay(twin)
        with trace.interval("graph.replay", self.device):
            self._load(block)
            (self.graph if twin is None else twin.graph).replay()
        if twin is None:
            self._outs = self._graph_outs
        else:
            twin.replays += 1
            trace.after_replay()
            self._outs = twin.outs
        self.replays += 1
        return self._outs


class _TimedTwin:
    """A GraphedStep's stage-timed twin: its graph, the outputs in the
    graph's pool, the stages' events (name, start and end event) and its
    replays, as the tracer's ``before_replay`` reads them."""

    __slots__ = ("graph", "stages", "outs", "device", "replays")

    def __init__(self, graph, stages: list, outs, device: torch.device):
        self.graph, self.stages, self.outs = graph, stages, outs
        self.device = device
        self.replays = 0


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

    A replay launches the captured kernels without a call of their
    wrappers, so a caller who wants them counted hands the runner
    ``recorded``: a function that returns a running count of kernel calls
    recorded into CUDA graphs (``lambda: fused_fft1.captured`` for the
    fused fft1).  ``kernels_per_replay`` is the count its capture
    recorded (``GraphedStep.kernels``; 0 without ``recorded``), and
    ``kernel_launches`` that times the replays made."""

    def __init__(self, params: RxParams, k_steps: int = 16,
                 outputs: tuple = ("audio", "baseb"),
                 calibration: dict | None = None, *, device="cuda",
                 recorded: Callable[[], int] | None = None):
        self._setup(params, k_steps, outputs, calibration, device, recorded)
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

    def _setup(self, params, k_steps, outputs, calibration, device,
               recorded) -> None:
        """Device, geometry, tables and the caller's count of recorded
        kernel calls."""
        self.device = resolve_device(device)
        self._recorded = recorded or (lambda: 0)
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
        self.graphed = GraphedStep(step, self.tables, state, shape, dtype,
                                   args, recorded=self._recorded)
        self.kernels_per_replay = self.graphed.kernels
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
        """Launches of the counted kernels made by this runner's replays."""
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
            trace.add("d2h_bytes", collected[f][-1].nbytes)

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
        collected: dict[str, list] = {f: [] for f in self.outputs}
        for _ in self._calls(self._segments(iq), collected):
            pass
        return {f: self._concat(v) for f, v in collected.items()}

    def _calls(self, segments: list, collected: dict):
        """Run one call per segment into ``collected``; yields after each
        call is enqueued, so that a caller can drive runners on several
        devices in turns, and returns once every output is on the host.

        Each call is a root span ``batch.call`` (``utils/trace.py``):
        ``batch.stage`` (the segment into the page-locked slot),
        ``batch.enqueue`` (the copy in, the K replays, the copies out and
        the event), and before them, for the call two before that used
        the slot, ``batch.wait`` and ``batch.collect`` (its outputs out of
        the slot); the last two calls' wait and collect follow in a span
        ``batch.drain`` of no call."""

        def drain(slot: _Slot) -> None:
            if slot.busy:
                with trace.span("batch.wait"):
                    slot.done.synchronize()
                with trace.span("batch.collect"):
                    self._collect(slot.out, collected)
                slot.busy = False

        n_in = self._blocks.numel() * self._blocks.element_size()
        for i, seg in enumerate(segments):
            with trace.root("batch.call"):
                trace.add("h2d_bytes", n_in)
                if self._slots is None:         # the CPU: no staging
                    with trace.span("batch.stage"):
                        self._blocks.copy_(torch.from_numpy(
                            np.ascontiguousarray(seg)))
                    with trace.span("batch.enqueue"):
                        self._run_call()
                    with trace.span("batch.collect"):
                        self._collect(self._stacks, collected)
                else:
                    self._enqueue(self._slots[i % 2], seg, drain)
            yield
        if self._slots is not None:
            with trace.span("batch.drain"):
                drain(self._slots[len(segments) % 2])
                drain(self._slots[(len(segments) + 1) % 2])

    def _enqueue(self, slot: _Slot, seg: np.ndarray, drain) -> None:
        """One call on the card: the slot drained of the call two before,
        the segment staged into it, then the copies and replays enqueued."""
        # the runner's card is the current device while it enqueues: the
        # replays and the event go to that card's stream
        with torch.cuda.device(self.device):
            drain(slot)                     # call i-2 has left it
            with trace.span("batch.stage"):
                slot.inp.numpy()[...] = seg
            with trace.span("batch.enqueue", self.device):
                with trace.interval("batch.h2d", self.device):
                    self._blocks.copy_(slot.inp, non_blocking=True)
                self._run_call()
                for f in self.outputs:
                    slot.out[f].copy_(self._stacks[f], non_blocking=True)
                slot.done.record()
            slot.busy = True
