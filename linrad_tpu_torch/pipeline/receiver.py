"""Host-side receivers (port of linrad_tpu/pipeline/receiver.py).

:class:`Receiver` owns the configuration, builds geometry, tables and
state on one device, and streams blocks through the step.  The host
slices input blocks, hands back outputs and runs the weak-signal control
(``control.WeakSignalControl``: the AFC's one read of the power spectrum
per step, the spur manager's scan about once a second of signal time);
tuning is kept as device tensors (integer bin plus fractional-bin ramp,
per frame once the AFC tracks), so a retune changes no shape.

:class:`MultiReceiver` runs K independently tuned sub-receivers over one
wideband front end; :class:`Transport` pauses, resumes and seeks a replay
between steps.

Both receivers run on ``device="cuda"`` unless the caller names another
device, and raise when there is no CUDA device: nothing carries on on the
CPU by itself.

On a CUDA device both replay their step from CUDA graphs
(:class:`.batch.GraphedStep`), the port's counterpart of the JAX
receivers' ``jax.jit``: the graphs are captured when the receiver is
made, one per tuning structure its parameters can reach (JAX compiles
once per structure too), over one set of static state, table and input
buffers.  The host work that the JAX receivers do per step (the AFC's
read, the spur manager, the resampler, the hooks) runs outside the
graph, on copies of the outputs that the caller owns.  ``graphed=False``
asks for the eager step on the card; on the CPU the step is eager unless
``graphed=True``, which runs the same graph bodies eagerly.  A capture
that fails raises: nothing gives way to the eager step by itself.

``Receiver.run_file`` replays a WAV recording through the runtime's file
prefetcher (disk reads overlap the device's work) and stages each block
through page-locked memory.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import time

import numpy as np
import torch

from ..geometry import Geometry, derive_geometry
from ..ops.blanker import BlankerTables
from ..ops.resample import Resampler
from ..params import Demod, RxParams
from .chain import (NBState, RxOutputs, RxState, RxTables, _map_tensors,
                    make_multi_rx_step, make_rx_step)
from .control import WeakSignalControl


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Receiver: device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return dev


class Transport:
    """File-replay transport: pause, resume and seek take effect between
    steps (the diskread_pause_flag and seek handling of the reference's
    file input, menu.c:888-896).  Thread-safe: drive it from another
    thread while the run() generator is being consumed."""

    def __init__(self):
        self._running = threading.Event()
        self._running.set()
        self._seek_seconds: float | None = None
        self._lock = threading.Lock()

    def pause(self) -> None:
        self._running.clear()

    def resume(self) -> None:
        self._running.set()

    @property
    def paused(self) -> bool:
        return not self._running.is_set()

    def seek(self, seconds: float) -> None:
        """Jump the replay position (forward or back)."""
        with self._lock:
            self._seek_seconds = max(0.0, float(seconds))

    def _next_index(self, i: int, step_seconds: float) -> int:
        self._running.wait()
        with self._lock:
            if self._seek_seconds is not None:
                i = int(self._seek_seconds / step_seconds)
                self._seek_seconds = None
        return i


def _as_block(block, geo: Geometry, device: torch.device) -> torch.Tensor:
    """One step of input as a tensor on the device: (samples_per_step, C)
    complex64, or (2*samples_per_step, C) float32 for real input
    (timf1_sampling_speed is half the A/D rate then, buf.c:47-51)."""
    if geo.iq_input:
        dtype, expect = torch.complex64, geo.samples_per_step
    else:
        dtype, expect = torch.float32, 2 * geo.samples_per_step
    block = torch.as_tensor(block).to(device=device, dtype=dtype)
    if block.dim() == 1:
        block = block[:, None]
    if tuple(block.shape) != (expect, geo.channels):
        raise ValueError(f"process_block: block {tuple(block.shape)}, "
                         f"expected {(expect, geo.channels)}")
    return block


def _block_rows(geo: Geometry) -> int:
    return geo.samples_per_step if geo.iq_input else 2 * geo.samples_per_step


def _block_dtype(geo: Geometry) -> torch.dtype:
    return torch.complex64 if geo.iq_input else torch.float32


def graph_wanted(device: torch.device, graphed: bool | None) -> bool:
    """``graphed=None``: CUDA graphs on a CUDA device, the eager step
    elsewhere; True or False as the caller asks."""
    return device.type == "cuda" if graphed is None else bool(graphed)


def tuning_structures(params: RxParams, geo: Geometry) -> dict:
    """The shapes of (tune_bin, tune_frac, tune_slope) that a receiver with
    these parameters can reach, by name (None: no slope): one integer bin
    and its fraction always; per-frame bins from the AFC; per-frame bins,
    fractions and slopes from the coherent AFC
    (``WeakSignalControl.update``)."""
    n = (geo.fftx_frames_per_step,)
    structures = {"bin": ((), (), None)}
    if params.afc_enable:
        if params.afc_coherent:
            structures["coherent"] = (n, n, n)
        else:
            structures["frames"] = (n, (), None)
    return structures


def _structure(tune: tuple) -> tuple:
    return tuple(None if t is None else tuple(t.shape) for t in tune)


def _tuning_args(shapes: tuple, device) -> tuple:
    """Static tuning tensors of the given (bin, frac, slope) shapes."""
    b, f, sl = shapes
    return (torch.zeros(b, dtype=torch.int64, device=device),
            torch.zeros(f, dtype=torch.float32, device=device),
            None if sl is None else torch.zeros(sl, dtype=torch.float32,
                                                device=device))


def _owned(out: RxOutputs) -> RxOutputs:
    """The outputs copied out of a graph's memory pool."""
    return _map_tensors(torch.clone, out)


@dataclasses.dataclass
class MultiState:
    """The multi-receivers' carried state as one tree: the wideband state
    and the K sub-receivers' stacked narrowband states."""

    rx: RxState
    nbs: NBState


def pair_step(multi_step):
    """A multi-receiver step, ``((state, nbs), outputs)`` from ``(tables,
    state, nbs, block, tune_bins)``, as a step on a :class:`MultiState`."""

    def step(tables, ms: MultiState, block, tune_bins):
        (s, nbs), out = multi_step(tables, ms.rx, ms.nbs, block, tune_bins)
        return MultiState(rx=s, nbs=nbs), out

    return step


class GraphedReceiver:
    """What a receiver that replays its step from CUDA graphs keeps.

    ``graphed``: whether it does; ``graphs``: the captured steps by tuning
    structure (:func:`tuning_structures`), all over one set of static
    buffers; ``kernels_per_replay`` and ``kernel_launches``: the counted
    kernels recorded in a graph (the most any of them records) and
    launched by this receiver's replays.  A replay launches the captured
    kernels without a call of their wrappers, so a caller who wants them
    counted hands the receiver ``recorded``, a running count of kernel
    calls recorded into CUDA graphs (``lambda: fused_fft1.captured``)."""

    graphed = False
    graphs: dict

    def _capture_graphs(self, steps: dict, tables, state, block_shape,
                        dtype: torch.dtype, recorded) -> None:
        """steps: name -> (step, static args), captured in order; the
        first graph owns the static buffers and the others share them."""
        from .batch import GraphedStep
        lead = None
        for name, (step, args) in steps.items():
            g = GraphedStep(step, tables, state, block_shape, dtype, args,
                            share=lead, recorded=recorded)
            lead = lead or g
            self.graphs[name] = g

    @property
    def _lead(self):
        """The graph that owns the static buffers."""
        return next(iter(self.graphs.values()))

    def _carried(self):
        """The carried state (the graphs' static buffers when graphed)."""
        return self._lead.state if self.graphs else self._state

    def _carry(self, value) -> None:
        if self.graphs:
            self._lead.state = value        # copies the leaves that changed
        else:
            self._state = value

    @property
    def state(self):
        """The carried state (the graphs' static buffers when graphed);
        assigning copies into them."""
        return self._carried()

    @state.setter
    def state(self, value) -> None:
        self._carry(value)

    @property
    def tables(self) -> RxTables:
        return self._tables

    @tables.setter
    def tables(self, value: RxTables) -> None:
        if self.graphs:
            self._lead.tables = value       # copied into the graphs' tables
        else:
            self._tables = value

    def _graph_for(self, tune: tuple):
        """The graph captured for the structure of ``tune``, with ``tune``
        written into its static tuning tensors."""
        key = _structure(tune)
        for g in self.graphs.values():
            if _structure(g.args) == key:
                for static, t in zip(g.args, tune):
                    if t is not None and t is not static:
                        static.copy_(t)
                return g
        captured = [_structure(g.args) for g in self.graphs.values()]
        raise ValueError(f"no graph was captured for tuning of shapes "
                         f"{key}; captured: {captured}")

    @property
    def kernels_per_replay(self) -> int:
        return max((g.kernels for g in self.graphs.values()), default=0)

    @property
    def kernel_launches(self) -> int:
        return sum(g.kernels * g.replays for g in self.graphs.values())


class PairedState:
    """``state`` and ``nbs`` of a multi-receiver, whose carried state is a
    :class:`MultiState`; assigning either copies into the graph's."""

    @property
    def state(self) -> RxState:
        return self._carried().rx

    @state.setter
    def state(self, value: RxState) -> None:
        self._carry(dataclasses.replace(self._carried(), rx=value))

    @property
    def nbs(self) -> NBState:
        return self._carried().nbs

    @nbs.setter
    def nbs(self, value: NBState) -> None:
        self._carry(dataclasses.replace(self._carried(), nbs=value))


def _pulsewidth(geo: Geometry) -> int:
    if not geo.second_fft_enable:
        return 2
    return BlankerTables.create(geo, "cpu")[1]


class Receiver(GraphedReceiver):
    # RF-dial frequency control (the freq_control.c graph: hardware
    # frequency = passband centre + converter offset, with optional
    # spectrum inversion).  center_frequency_hz is the recording's RF
    # centre (fg.passband_center).
    center_frequency_hz: float = 0.0

    def __init__(self, params: RxParams, calibration: dict | None = None,
                 audio_out_rate: float | None = None, *, device="cuda",
                 graphed: bool | None = None, recorded=None):
        """calibration: optional {'filtercorr': ..., 'iq_corr': ...} (from
        :mod:`..calibration`).  device: where tables, state and every step
        live ("cuda", "cuda:1", "cpu"); the default needs a CUDA device.
        audio_out_rate: resample the audio to this rate (the rx_output
        D/A resampler, rxout.c:266); it must give an integer output count
        per step (exact rational, ops/resample.py).  graphed: replay the
        step from CUDA graphs, one per tuning structure, captured here
        (None: on a CUDA device; see the module's docstring).  recorded:
        a running count of kernel calls recorded into CUDA graphs, for
        ``kernel_launches``."""
        self.graphs = {}
        self.device = resolve_device(device)
        self.params = params
        self.geo: Geometry = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device,
                                      calibration)
        ac = None
        if params.demod == Demod.COHERENT and params.coherent_mode == 1:
            # signal ear + carrier ear (bg_coherent 1, mix2.c:1843)
            ac = 2 * (1 if params.pol_adapt_enable else self.geo.channels)
        fir = self.tables.mix2.fir
        self.state = RxState.create(
            self.geo, self.device, spur=params.spur_enable,
            pol=params.pol_adapt_enable,
            fir_len=int(fir.shape[0]) if fir is not None else 0,
            audio_channels=ac)
        self.blanker_pulsewidth = _pulsewidth(self.geo)
        self._step = make_rx_step(self.geo, params,
                                  blanker_pulsewidth=self.blanker_pulsewidth,
                                  fractional_tune=True)
        self._tune_bin = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._tune_frac = torch.zeros((), dtype=torch.float32,
                                      device=self.device)
        self._tune_slope = None  # per-frame drift once the AFC locks
        self._step_seconds = (self.geo.samples_per_step
                              / self.geo.timf1_sampling_speed)
        self.control = WeakSignalControl(self.geo, params, self.device)
        # optional audio-rate conversion (rx_output resampler analog)
        self.audio_out_rate = audio_out_rate
        self._resampler = None
        self._resampler_state = None
        if audio_out_rate:
            # 32-tap windowed sinc: interpolation and anti-image filtering
            # in one contraction (the reference needs a separate IIR after
            # its 4-point interpolator, rxout.c:1165-1210).  Sized with
            # geo.channels, as the JAX Receiver sizes it.
            self._resampler = Resampler(
                self.geo.baseband_sampling_speed, audio_out_rate,
                self.geo.baseband_samples_per_step, self.geo.channels,
                self.device, taps=32)
            self._resampler_state = self._resampler.init_state()
        # user-extension hooks, the users_*.c plugin surface
        # (users_init_mode menu.c:693, users_extra_fast wcw.c:931-937,
        # hware_command users.c:41):
        #   "init": fn(receiver)              after construction
        #   "extra_fast": fn(receiver, out)   every step, before control
        #   "block": fn(receiver, out)        every step, after control
        #   "tune": fn(receiver, freq_hz)     on retune
        self.hooks: dict[str, list] = {"init": [], "extra_fast": [],
                                       "block": [], "tune": []}
        self.graphed = graph_wanted(self.device, graphed)
        if self.graphed:
            self._capture_graphs(
                {name: (self._step, _tuning_args(shapes, self.device))
                 for name, shapes in tuning_structures(params,
                                                       self.geo).items()},
                self._tables, self._state,
                (_block_rows(self.geo), self.geo.channels),
                _block_dtype(self.geo), recorded)
            self._state = None

    def add_hook(self, event: str, fn) -> None:
        """Register a user hook (users_*.c extension API analog)."""
        self.hooks[event].append(fn)

    def _fire(self, event: str, *args) -> None:
        for fn in self.hooks.get(event, ()):
            fn(self, *args)

    @property
    def afc(self):
        return self.control.afc

    @property
    def spur_manager(self):
        return self.control.spur_manager

    @property
    def _steps_done(self) -> int:
        return self.control.steps_done

    @_steps_done.setter
    def _steps_done(self, v: int) -> None:
        self.control.steps_done = v

    # ---- tuning -------------------------------------------------------
    def tune_rf(self, rf_hz: float) -> None:
        """Tune to an absolute RF (dial) frequency, mapping through the
        converter offset and the passband direction."""
        p = self.params
        base = rf_hz - p.converter_offset_hz - self.center_frequency_hz
        if p.passband_direction < 0:
            base = -base
        self.tune(base)

    @property
    def tuned_rf_hz(self) -> float:
        base = self.tuned_hz
        if self.params.passband_direction < 0:
            base = -base
        return (base + self.center_frequency_hz
                + self.params.converter_offset_hz)

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
        self._tune_slope = None
        self.control.on_tune(freq_hz)
        self._fire("tune", freq_hz)

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
        """Process one step of input: (samples_per_step, C) complex IQ, or
        (2*samples_per_step, C) float32 in real-input mode; a numpy array
        or a tensor on any device."""
        block = _as_block(block, self.geo, self.device)
        out = self._advance(block)
        if self.graphs:
            out = _owned(out)
        if self._resampler is not None:
            self._resampler_state, resampled = self._resampler(
                self._resampler_state, out.audio)
            out = dataclasses.replace(out, audio=resampled)
        self._fire("extra_fast", out)
        (self._tune_bin, self._tune_frac, self._tune_slope,
         self.state) = self.control.update(
            out, self._tune_bin, self.state, tune_frac=self._tune_frac,
            tune_slope=self._tune_slope)
        self._fire("block", out)
        return out

    def _advance(self, block: torch.Tensor) -> RxOutputs:
        """The step on a block already on the device, from the current
        state and tuning; the state moves on, nothing else runs.  When
        graphed, the outputs are the graph's, overwritten by its next
        replay."""
        tune = (self._tune_bin, self._tune_frac, self._tune_slope)
        if not self.graphs:
            self.state, out = self._step(self.tables, self.state, block,
                                         *tune)
            return out
        return self._graph_for(tune)(block)

    def run(self, iq: np.ndarray, *, transport: Transport | None = None,
            pace: bool = False, watchdog=None, monitor=None):
        """Stream a recording; yields RxOutputs per step and drops the
        final partial block (modesub.c:1022).

        transport: optional pause/resume/seek control between steps.
        pace: replay at the recording's real-time rate, as the reference's
        file input thread paces to the A/D speed.  watchdog: any object
        with ``beat(name)``, which gets a "receiver" heartbeat per step;
        monitor: any object with ``advance(n)``, advanced by each step's
        raw input sample count (so its rate is the A/D rate
        geo.rx_ad_speed for IQ and real input alike)."""
        if iq.ndim == 1:
            iq = iq[:, None]
        s = _block_rows(self.geo)
        n_steps = iq.shape[0] // s
        t0 = time.monotonic()
        done = 0
        i = 0
        while i < n_steps:
            if transport is not None:
                i = transport._next_index(i, self._step_seconds)
                if i >= n_steps:
                    break
            if pace:
                delay = t0 + done * self._step_seconds - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            out = self.process_block(iq[i * s:(i + 1) * s])
            if watchdog is not None:
                watchdog.beat("receiver")
            if monitor is not None:
                monitor.advance(s)  # raw input samples (A/D rate)
            yield out
            i += 1
            done += 1

    def run_file(self, path: str):
        """Stream a .wav recording through the native file prefetcher
        (runtime ring buffer + background reader, the
        THREAD_RX_FILE_INPUT analog): disk I/O overlaps device compute.
        Yields RxOutputs per step.  The RF centre frequency of an
        ``rcvr`` or ``auxi`` chunk becomes ``center_frequency_hz``."""
        from .. import runtime
        from ..io.wav import AuxiChunk, RcvrChunk, read_wav

        # parse the header once to learn the layout, then stream the
        # payload through the prefetcher
        with open(path, "rb") as f:
            riff = f.read(12)
            if riff[:4] != b"RIFF":
                raise ValueError(f"{path}: not a WAV")
            fmt = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    raise ValueError(f"{path}: missing data chunk")
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(csize)
                elif cid == b"rcvr":
                    # RF centre from the capture metadata -> dial tuning
                    self.center_frequency_hz = float(
                        RcvrChunk.unpack(f.read(csize)).center_frequency_hz)
                elif cid == b"auxi":
                    self.center_frequency_hz = float(
                        AuxiChunk.unpack(f.read(csize)).center_freq)
                elif cid == b"data":
                    data_off = f.tell()
                    break
                else:
                    f.seek(csize + (csize & 1), 1)
        (_wformat, nch, _rate, _br, _al, bits) = struct.unpack("<HHIIHH",
                                                               fmt[:16])
        if bits != 16 or nch != 2 * self.geo.channels:
            # uncommon layouts go through the simple reader
            iq, info = read_wav(path)
            if info.rcvr is not None:
                self.center_frequency_hz = float(
                    info.rcvr.center_frequency_hz)
            elif info.auxi is not None:
                self.center_frequency_hz = float(info.auxi.center_freq)
            yield from self.run(iq)
            return
        frame_bytes = 2 * nch
        s = self.geo.samples_per_step
        pf = runtime.FilePrefetcher(path, block_bytes=s * frame_bytes,
                                    offset=data_off)
        # two host buffers in turn, page-locked when the device is a card,
        # so the copy to the device is asynchronous; a buffer is refilled
        # only after the event behind the copy that read it
        cuda = self.device.type == "cuda"
        stage = [torch.empty((s, nch // 2), dtype=torch.complex64,
                             pin_memory=cuda) for _ in range(2)]
        copied = [torch.cuda.Event() if cuda else None for _ in range(2)]
        i = 0
        while True:
            raw = pf.read_block()
            if len(raw) < s * frame_bytes:
                break
            buf = stage[i % 2]
            if cuda:
                copied[i % 2].synchronize()
            parts = torch.view_as_real(buf).numpy()     # (s, C, 2) float32
            parts[...] = np.frombuffer(raw, "<i2").reshape(s, nch // 2, 2)
            block = buf.to(self.device, non_blocking=True) if cuda \
                else buf.clone()
            if cuda:
                copied[i % 2].record()
            yield self.process_block(block)
            i += 1

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """Convenience: process a whole recording and concatenate the
        outputs on the host."""
        audio, baseb, gains = [], [], []
        power = None
        for out in self.run(iq):
            audio.append(out.audio.cpu().numpy())
            baseb.append(out.baseb.cpu().numpy())
            gains.append(out.agc_gain.cpu().numpy())
            power = out.fft1_avg_power.cpu().numpy()
        return {
            "audio": np.concatenate(audio) if audio else np.zeros((0, 1)),
            "baseb": np.concatenate(baseb) if baseb else np.zeros((0, 1)),
            "agc_gain": np.concatenate(gains) if gains else np.zeros((0, 1)),
            "fft1_avg_power": power,
        }


class MultiReceiver(PairedState, GraphedReceiver):
    """K independently tuned sub-receivers over ONE wideband front end
    (the reference's MIX1_NO_OF_CHANNELS=24 mix1 slots and network userx
    consumers, globdef.h:315, 1282-1294).  The narrowband tail runs once
    on tensors with a leading K axis, so K sub-receivers cost one set of
    device operations, not K.  On a CUDA device the step replays from one
    CUDA graph (``graphed``, ``recorded`` as for :class:`Receiver`); its
    carried state is the pair (``state``, ``nbs``)."""

    def __init__(self, params: RxParams, n_subch: int,
                 calibration: dict | None = None, *, device="cuda",
                 graphed: bool | None = None, recorded=None):
        self.graphs = {}
        self.device = resolve_device(device)
        self.params = params
        self.n_subch = n_subch
        self.geo: Geometry = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device,
                                      calibration)
        fir = self.tables.mix2.fir
        fir_len = int(fir.shape[0]) if fir is not None else 0
        self._state = MultiState(
            rx=RxState.create(self.geo, self.device,
                              spur=params.spur_enable, fir_len=fir_len),
            nbs=NBState.create_stacked(
                self.geo, n_subch, self.device, pol=params.pol_adapt_enable,
                fir_len=fir_len))
        self.blanker_pulsewidth = _pulsewidth(self.geo)
        self._step = pair_step(make_multi_rx_step(
            self.geo, params, blanker_pulsewidth=self.blanker_pulsewidth))
        self._tune_bins = torch.zeros(n_subch, dtype=torch.int64,
                                      device=self.device)
        self.graphed = graph_wanted(self.device, graphed)
        if self.graphed:
            # the graph reads the tuning where it is: tune_subch writes
            # into it
            self._capture_graphs({"bins": (self._step, (self._tune_bins,))},
                                 self._tables, self._state,
                                 (_block_rows(self.geo), self.geo.channels),
                                 _block_dtype(self.geo), recorded)
            self._state = None

    def tune_subch(self, k: int, freq_hz: float) -> None:
        """Tune sub-receiver k (quantised to an fftx bin); retuning any
        sub-receiver changes no shape."""
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune_bins[k] = int(round(freq_hz / fs * n)) % n

    def process_block(self, block) -> RxOutputs:
        """One step; outputs.audio/baseb/agc_gain have shape (K, S, C)."""
        block = _as_block(block, self.geo, self.device)
        if not self.graphs:
            self._state, out = self._step(self.tables, self._state, block,
                                          self._tune_bins)
            return out
        return _owned(self._graph_for((self._tune_bins,))(block))

    def run(self, iq: np.ndarray):
        """Stream a recording; yields RxOutputs per step."""
        if iq.ndim == 1:
            iq = iq[:, None]
        s = _block_rows(self.geo)
        for i in range(iq.shape[0] // s):
            yield self.process_block(iq[i * s:(i + 1) * s])
