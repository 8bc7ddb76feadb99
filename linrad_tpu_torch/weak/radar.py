"""Synchronized EME radar mode (port of linrad_tpu/weak/radar.py).

A re-design of ``run_radar`` (reference radar.c:121-520) and its display
accumulation ``update_radar_average`` (radar.c:86-118) /
``make_radar_timeconstant`` (radar.c:61-84).

The reference runs a dedicated thread that walks the shared
``fft1_sumsq`` ring transform-by-transform with data-dependent
while-loops (peak search, skirt walks, pulse grouping).  Here the
per-transform analysis (peak bin, bounded two-neighbour skirt walk,
out-of-skirt noise floor, S/N) is one batched function over all frames
of a step, ``walk_steps`` vectorised iterations with no host read
inside, and only the tiny pulse-train bookkeeping (threshold grouping,
median separation, lock state machine, radar.c:227-345) runs on host
scalars, mirroring the reference's control thread.  The display
accumulation is a decayed add of a slice of the frame history, on the
device.  :class:`RadarTracker` is host numpy around those two functions,
this package's copy of the JAX package's class.

The JAX package jits ``frame_pulse_stats`` and ``_accumulate``.  Here
:func:`frame_pulse_stats` is a custom operator: on a CUDA tensor one
launch of the hand-written kernel in ``csrc/radar_stats.cu`` (each frame's
peak, both bounded walks in closed form by a warp's ballot, the floor), on
a CPU tensor its plain version :func:`_frame_pulse_stats_reference`, the
loop that ran as some 970 small kernels a step on the card.
:class:`RadarFront` is the radar mode's device path for one block shape,
fft1 (the fused kernel with ``variant="pallas"``), the power and the
per-frame statistics, replayed from one CUDA graph per step
(:class:`..pipeline.batch.GraphedStep`).  ``_accumulate`` stays an eager
multiply-add of a slice, two kernels a display update: a graph would
replay the same, with ``start`` written to a device scalar before each
replay.

Each :meth:`RadarFront.feed` is a root span ``radar.block`` of the tracer
(``utils/trace.py``) over ``radar.h2d`` (the block's copy in),
``radar.replay`` (the graph's input copy and replay; ``radar.step`` for
the eager step), ``radar.owned`` (the outputs' copies out of the graph's
pool), ``radar.wait`` (on a CUDA device, a synchronise that takes the
front's device work out of the tracker's read) and ``radar.track``
(:meth:`RadarTracker.feed`).  Inside a tracker's feed: ``radar.read``
(the power and statistics to the host), ``radar.lock`` (the lock's
search) and ``radar.scan`` (the pulses' search in the pulse bin's column
and the display updates, each with its window's copy to the device).  The
tracer counts the bytes handed to the device (``h2d_bytes``: the block,
the display updates' windows) and read back (``d2h_bytes``), and
:func:`..utils.trace.report` reads the trackers' display updates as
``radar_updates``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..geometry import Geometry
from ..ops.fft1 import FFT1State, FFT1Tables, fft1_step
from ..pipeline.batch import GraphedStep
from ..pipeline.receiver import (_block_dtype, _block_rows, graph_wanted,
                                 resolve_device)
from ..utils import cuda_build, trace
from ..utils.host import to_numpy

SPEED_OF_LIGHT = 299_792_458.0


@dataclass
class RadarParams:
    """The radar-graph parameter block (``rg`` in radar.c).

    ``time`` is the display decay time constant: the accumulated
    amplitude falls by 1/e in ``time`` seconds (radar.c:61-84).
    ``gain``/``zero`` are the display intensity mapping of
    make_radar_cfac (radar.c:54-59).
    """

    time: float = 2.0
    gain: float = 10.0
    zero: float = 0.0
    max_lines: int = 256          # radar_maxlines analog
    max_bins: int = 64            # radar_bins analog (display width)
    min_pulses: int = 10          # radar.c:276 "if(ptr < 10)"
    lock_after: int = 500         # radar.c:236 "k>500" history depth
    ston_rel: float = 0.003       # radar.c:246 threshold 25 dB below best
    mute_ratio: float = 0.1       # radar.c:291 TX-noise/RX-noise bound
    mute_check: bool = True


STATS_MAX_N = 1 << 30   # bins a frame: the kernel's positions are int32
# launches of csrc/radar_stats.cu, made and recorded into CUDA graphs
stats_count = cuda_build.launch_count("radar_stats")
# the C launcher's argument types, the stream last
STATS_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
              + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def _frame_pulse_stats_reference(power: torch.Tensor, walk_steps: int = 32
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch version of :func:`frame_pulse_stats`: ``walk_steps``
    iterations over all frames at once, each a gather of three bins, the
    compares and a ``where``."""
    f, n = power.shape
    k = torch.argmax(power, dim=1)
    peak = torch.gather(power, 1, k[:, None])[:, 0]

    def walk(direction: int, idx: torch.Tensor) -> torch.Tensor:
        for _ in range(walk_steps):
            nxt = idx + direction
            nxt2 = idx + 2 * direction
            valid = (nxt2 >= 0) & (nxt2 <= n - 1)
            cur = torch.gather(power, 1, idx[:, None])[:, 0]
            a = torch.gather(power, 1, nxt.clamp(0, n - 1)[:, None])[:, 0]
            b = torch.gather(power, 1, nxt2.clamp(0, n - 1)[:, None])[:, 0]
            step = valid & (cur > a) & (cur > b)
            idx = torch.where(step, nxt, idx)
        return idx

    ia = walk(-1, k)
    ib = walk(+1, k) + 1          # radar.c:216 "ib++"
    bins = torch.arange(n, device=power.device)[None, :]
    outside = (bins < ia[:, None]) | (bins >= ib[:, None])
    t1 = torch.sum(torch.where(outside, power, 0.0), dim=1)
    cnt = (n - (ib - ia)).clamp(min=1)
    floor = t1 / cnt
    ston = peak / floor.clamp(min=1e-30)
    return k, ston, floor


def _check_stats(power: torch.Tensor, walk_steps: int) -> None:
    """Refuse what :func:`frame_pulse_stats` does not take: power (F, n)
    float32 with F >= 1 and 1 <= n < STATS_MAX_N; walk_steps >= 0.  Rows
    that are not dense are copied to rows that are before a launch."""
    if power.dim() != 2 or power.dtype != torch.float32 \
            or power.shape[0] < 1 or not 1 <= power.shape[1] < STATS_MAX_N:
        raise ValueError(f"frame_pulse_stats: power must be (F, n) float32 "
                         f"with F >= 1 and 1 <= n < {STATS_MAX_N}, got "
                         f"{tuple(power.shape)} {power.dtype}")
    if walk_steps < 0:
        raise ValueError(f"frame_pulse_stats: walk_steps {walk_steps} < 0")


def _stats_launch(power: torch.Tensor, walk_steps: int):
    """One launch for R streams of F frames, power (R, F, n), over its R F
    rows, each row dense, rows any stride apart.  A walk takes at most
    n - 3 steps, so the kernel is handed min(walk_steps, n).  Returns
    (peak_bin, ston, noise_floor), each (R, F)."""
    r, f, n = power.shape
    power = power.reshape(r * f, n)
    if not power[0].is_contiguous():
        power = power.contiguous()
    rows = r * f
    dev = power.device
    k = torch.empty(rows, dtype=torch.int64, device=dev)
    ston = torch.empty(rows, dtype=torch.float32, device=dev)
    floor = torch.empty(rows, dtype=torch.float32, device=dev)
    cuda_build.launch(
        cuda_build.bind("radar_stats", "lrt_radar_stats", STATS_ARGS), (
            power.data_ptr(), k.data_ptr(), ston.data_ptr(),
            floor.data_ptr(), power.stride(0), rows, n,
            min(walk_steps, n)), dev,
        f"frame_pulse_stats at ({rows}, {n})", stats_count)
    return tuple(t.reshape(r, f) for t in (k, ston, floor))


_stats = cuda_build.Streams("frame_pulse_stats", _check_stats,
                            _frame_pulse_stats_reference, _stats_launch)


def frame_pulse_stats(power: torch.Tensor, walk_steps: int = 32
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-transform pulse statistics, batched over frames.

    power: (frames, fft1_size) float32 power spectra (the fft1_sumsq
    rows of radar.c:195-226).  Returns per-frame ``(peak_bin, ston,
    noise_floor)``: int64, float32, float32.

    The reference walks the skirt with ``while(ia>1 && p[ia]>p[ia-1] &&
    p[ia]>p[ia-2]) ia--`` (radar.c:206-215), unbounded in C; here at most
    ``walk_steps`` steps a side, a step that fails ending the walk (radar
    pulses are narrow; 32 bins each side is far beyond any real skirt, and
    the walk freezes at the first failing bin exactly like the C).

    On a CUDA tensor one launch of ``csrc/radar_stats.cu`` (the walks as
    the count of steps that pass in a row, by a warp's ballot): the peak
    bins and walk ends bit for bit the plain version's, the floor and S/N
    to the rounding of a float32 sum taken in another order; on a CPU
    tensor the plain version :func:`_frame_pulse_stats_reference`.
    Through the PyTorch custom operator
    ``torch.ops.linrad_tpu_torch.frame_pulse_stats``, with a rule for
    ``torch.func.vmap``: R streams of F frames make one launch over R F
    rows (``_stats.vmap``).  Its launches are counted in
    ``stats_count``."""
    return torch.ops.linrad_tpu_torch.frame_pulse_stats(power, walk_steps)


@torch.library.custom_op("linrad_tpu_torch::frame_pulse_stats",
                         mutates_args=())
def _frame_pulse_stats_op(power: torch.Tensor, walk_steps: int
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    return _stats(power, walk_steps)


@_frame_pulse_stats_op.register_fake
def _frame_pulse_stats_fake(power, walk_steps):
    _check_stats(power, walk_steps)
    f = power.shape[0]
    return (power.new_empty(f, dtype=torch.int64), power.new_empty(f),
            power.new_empty(f))


_frame_pulse_stats_op.register_vmap(_stats.vmap)


def _accumulate(avg: torch.Tensor, frames: torch.Tensor, start: int,
                decayfac: float, lines: int, first_bin: int,
                last_bin: int) -> torch.Tensor:
    """One radar-display update (update_radar_average radar.c:108-117):
    ``avg = avg*decayfac + frames[start:start+lines, first:last]``.
    ``start`` is the host integer the tracker computed: slicing with it
    reads nothing back from the device."""
    return avg * decayfac + frames[start:start + lines, first_bin:last_bin]


def frame_power(spec: torch.Tensor) -> torch.Tensor:
    """(frames, bins, channels) fft1 spectra -> (frames, bins) float32
    power, summed over the channels as :meth:`RadarTracker.feed` sums."""
    return (spec.abs() ** 2).sum(-1)


def radar_step(geo: Geometry, avg1num: int, variant: str | None = None):
    """One step of the radar mode's device path, ``(tables, state, block)
    -> (state, (power, peak_bin, ston, noise_floor))``: fft1, the power of
    each frame and its pulse statistics."""

    def step(tables: FFT1Tables, state: FFT1State, block: torch.Tensor):
        state, spec, _ = fft1_step(geo, tables, state, block, avg1num,
                                   variant=variant)
        power = frame_power(spec)
        return state, (power,) + frame_pulse_stats(power)

    return step


class RadarFront:
    """The radar mode's device path for blocks of one shape: fft1 (the
    fused kernel with ``variant="pallas"``), each frame's power and
    :func:`frame_pulse_stats`, replayed from one CUDA graph per step on a
    CUDA device (``graphed=None``; ``graphed=False`` for the eager step;
    on the CPU the step is eager unless ``graphed=True``, which runs the
    graph's body eagerly).  The fft1 state carries from block to block.

    ``recorded`` as for the receivers: a running count of kernel calls
    recorded into CUDA graphs, read around the capture, for
    ``kernel_launches``.  :meth:`feed` hands a block's power and
    statistics to a :class:`RadarTracker`, which then computes nothing on
    the device but its display."""

    def __init__(self, geo: Geometry, tables: FFT1Tables, *, avg1num: int,
                 variant: str | None = None, device="cuda",
                 graphed: bool | None = None, recorded=None):
        self.device = resolve_device(device)
        self.geo = geo
        self._step = radar_step(geo, avg1num, variant)
        self._tables = tables
        self._state = FFT1State.create(geo, self.device)
        self._shape = (_block_rows(geo), geo.channels)
        self._dtype = _block_dtype(geo)
        self.graph = None
        if graph_wanted(self.device, graphed):
            self.graph = GraphedStep(self._step, tables, self._state,
                                     self._shape, self._dtype,
                                     recorded=recorded)
            self._state = None

    @classmethod
    def of_receiver(cls, rx, **kw) -> "RadarFront":
        """The radar path of a receiver's front end: its geometry, fft1
        tables (calibration included), averaging, variant and device."""
        kw.setdefault("device", rx.device)
        return cls(rx.geo, rx.tables.fft1, avg1num=rx.params.fft_avg1num,
                   variant=rx.params.fft1_variant, **kw)

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    @property
    def state(self) -> FFT1State:
        return self.graph.state if self.graph else self._state

    @property
    def kernel_launches(self) -> int:
        return self.graph.kernels * self.graph.replays if self.graph else 0

    def __call__(self, block) -> tuple[torch.Tensor, ...]:
        """(power (frames, bins), peak_bin, ston, noise_floor) of one block
        ((samples_per_step, C) complex64, a tensor or a numpy array), the
        caller's own tensors on the device."""
        with trace.span("radar.h2d", self.device):
            block = torch.as_tensor(block)
            host = block.device.type == "cpu"
            block = block.to(device=self.device, dtype=self._dtype)
            if host:
                trace.add("h2d_bytes", block.numel() * block.element_size())
            block = block.reshape(self._shape)
        if self.graph is None:
            with trace.span("radar.step", self.device):
                self._state, out = self._step(self._tables, self._state,
                                              block)
            return out
        with trace.span("radar.replay"):
            out = self.graph(block)
        with trace.span("radar.owned", self.device):
            return tuple(t.clone() for t in out)

    def feed(self, tracker: "RadarTracker", block) -> None:
        with trace.root("radar.block"):
            power, *stats = self(block)
            if self.device.type == "cuda":
                # the tracker's read would wait here anyway
                with trace.span("radar.wait"):
                    torch.cuda.synchronize(self.device)
            with trace.span("radar.track"):
                tracker.feed(power, stats=stats)


@dataclass(eq=False)
class RadarTracker:
    """The run_radar state machine (radar.c:121-520).

    Feed per-frame fft1 power spectra step-by-step with :meth:`feed`.
    Unlocked, it accumulates per-frame S/N history until it can identify
    the transmitted pulse train (threshold 25 dB below the best S/N,
    ≥``min_pulses`` pulses, TX-mute noise check, median separation —
    radar.c:227-345).  Locked, every detected pulse triggers a decayed
    accumulation of the following ``lines`` transforms into the radar
    display, synchronised to the pulse end exactly as
    update_radar_average does (peak search ±4, 1 %-of-peak end walk,
    back up 10 transforms).
    """

    n_bins: int
    frame_time_s: float
    params: RadarParams = field(default_factory=RadarParams)
    bin_hz: float = 0.0           # fft1 bin bandwidth, for doppler readout

    locked: bool = False
    pulse_sep: int = 0            # transforms between pulses
    pulse_bin: int = 0
    lines: int = 0
    first_bin: int = 0
    last_bin: int = 0
    decayfac: float = 1.0
    update_cnt: int = 0
    device: str = "cuda"          # where the two device functions run

    def __post_init__(self):
        self._device = torch.device(self.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RadarTracker: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self._hist_pw: list[np.ndarray] = []   # buffered power frames
        self._bins: list[int] = []
        self._ston: list[float] = []
        self._floor: list[float] = []
        self._consumed = 0                     # frames dropped from front
        self._avg: torch.Tensor | None = None
        self._next_scan = 0                    # first unscanned frame
        trace.watch("radar_updates", self, "update_cnt")

    # ------------------------------------------------------------------
    def feed(self, power_frames, stats=None) -> None:
        """Consume one step's (frames, fft1_size) power spectra, or
        (frames, fft1_size, channels), summed over the channels.

        A tensor goes to :func:`frame_pulse_stats` on its own device, a
        numpy array to the tracker's device; the history keeps one host
        copy.  ``stats``: the spectra's ``(peak_bin, ston, noise_floor)``
        when the caller has them already (:meth:`RadarFront.feed`)."""
        pw = None
        if isinstance(power_frames, torch.Tensor):
            dev = power_frames.detach().to(torch.float32)
            if dev.dim() == 3:                 # (frames, bins, channels)
                dev = dev.sum(-1)
        else:
            pw = to_numpy(power_frames, np.float32)
            if pw.ndim == 3:
                pw = pw.sum(axis=2)
            dev = torch.from_numpy(pw).to(self._device)
            trace.add("h2d_bytes", pw.nbytes)
        if stats is None:
            stats = frame_pulse_stats(dev)
        with trace.span("radar.read"):
            if pw is None:
                # the history's own copy (a CPU tensor's numpy view would
                # follow the caller's later writes), page-locked when read
                # from a card: the card writes it in place, where a
                # pageable read goes through a staging buffer and a memcpy
                pw = torch.empty(dev.shape, dtype=dev.dtype,
                                 pin_memory=dev.device.type == "cuda")
                pw = pw.copy_(dev).numpy()
                trace.add("d2h_bytes", pw.nbytes)
            k, ston, floor = (to_numpy(t) for t in stats)
            trace.add("d2h_bytes", k.nbytes + ston.nbytes + floor.nbytes)
        self._hist_pw.append(pw)
        self._bins.extend(k.tolist())
        self._ston.extend(ston.tolist())
        self._floor.extend(floor.tolist())
        if not self.locked:
            with trace.span("radar.lock"):
                self._try_lock()
        if self.locked:
            with trace.span("radar.scan"):
                self._scan_pulses()
        self._trim()

    # ------------------------------------------------------------------
    def _pulse_centers(self, ston: np.ndarray) -> tuple[np.ndarray, float]:
        """Group above-threshold transforms into pulses (radar.c:246-270).
        Returns (center indices, per-pulse threshold used)."""
        ref = float(np.max(ston)) * self.params.ston_rel
        idx = np.flatnonzero(ston > ref)
        if len(idx) == 0:
            return np.array([], int), ref
        breaks = np.flatnonzero(np.diff(idx) > 1)
        run_starts = np.concatenate([[idx[0]], idx[breaks + 1]])
        run_ends = np.concatenate([idx[breaks], [idx[-1]]])
        centers = (run_starts + run_ends) // 2
        return centers, ref

    def _try_lock(self) -> None:
        p = self.params
        n_hist = len(self._ston)
        if n_hist < p.lock_after:
            return
        ston = np.array(self._ston)
        floor = np.array(self._floor)
        centers, _ref = self._pulse_centers(ston)
        # drop a possibly-truncated first/last pulse (radar.c:257-263
        # skips a pulse too close to the scan start)
        centers = centers[(centers > 2) & (centers < n_hist - 3)]
        if len(centers) < p.min_pulses:
            return
        if p.mute_check:
            # during TX the RX noise floor must be well below the
            # receive-period floor (radar.c:283-292)
            tx_floor = float(np.mean(floor[centers]))
            all_floor = float(np.mean(floor))
            if all_floor <= 0 or tx_floor / all_floor > p.mute_ratio:
                return
        seps = np.diff(centers)
        self.pulse_sep = int(np.median(seps))   # radar.c:296-320
        if self.pulse_sep < 2:
            return
        self.pulse_bin = int(round(np.mean(
            np.array(self._bins)[centers])))    # radar.c:321
        self.lines = min(self.pulse_sep + 20, p.max_lines)  # radar.c:324
        k = min(self.n_bins, p.max_bins) // 2   # radar.c:327-340
        first = self.pulse_bin - k
        last = self.pulse_bin + k
        if first < 0:
            last -= first
            first = 0
        if last > self.n_bins:
            first += self.n_bins - last
            last = self.n_bins
        self.first_bin, self.last_bin = first, last
        # make_radar_timeconstant (radar.c:61-84): fall by 1/e in rg.time
        t2 = min(p.time, 5.0)
        self.decayfac = float(
            0.368 ** (self.pulse_sep * self.frame_time_s / t2)) \
            if t2 > 0 else 0.0
        self._avg = torch.zeros((self.lines, last - first),
                                dtype=torch.float32, device=self._device)
        self.locked = True
        # restart scanning from the first whole pulse window
        self._next_scan = self._consumed

    # ------------------------------------------------------------------
    def _scan_pulses(self) -> None:
        """Locked-mode accumulation (radar.c:86-118, 346-420).  The history
        stays a list of blocks: the scan reads the pulse bin's column of
        it, and a display update copies only its own window of frames to
        the device, so that a block's host work does not grow with the
        history (some 1,300-1,600 frames at a pulse every 2.7 s)."""
        col = np.concatenate([a[:, self.pulse_bin] for a in self._hist_pw]) \
            if self._hist_pw else np.zeros(0, np.float32)
        n = len(col)
        ston = np.array(self._ston)
        centers, _ = self._pulse_centers(ston)
        for c in centers:
            if c < self._next_scan - self._consumed:
                continue
            # update_radar_average: max at pulse_bin within ±4 (radar.c:
            # 92-105), walk to the pulse end (1 % of peak), back up 10
            lo = max(c - 4, 0)
            hi = min(c + 5, n)
            if hi <= lo:
                continue
            ia = lo + int(np.argmax(col[lo:hi]))
            t1 = col[ia]
            while ia + 1 < n and 0.01 * t1 < col[ia]:
                ia += 1
            start = ia - 10
            if start < 0:
                # the window's head has already left the history buffer —
                # unrecoverable; skip this pulse permanently so scanning
                # (and trimming) can advance
                self._next_scan = self._consumed + c + max(
                    self.pulse_sep // 2, 1)
                continue
            if start + self.lines > n:
                continue    # window not fully buffered yet; retry later
            window = self._window(start)
            trace.add("h2d_bytes", window.nbytes)
            self._avg = _accumulate(
                self._avg, torch.from_numpy(window).to(self._device), 0,
                self.decayfac, self.lines, 0, self.last_bin - self.first_bin)
            self.update_cnt += 1
            self._next_scan = self._consumed + c + max(
                self.pulse_sep // 2, 1)

    def _window(self, start: int) -> np.ndarray:
        """History frames [start, start + lines), the display's bins only,
        gathered from the blocks they lie in."""
        parts, pos, stop = [], 0, start + self.lines
        for a in self._hist_pw:
            lo, hi = max(start - pos, 0), min(stop - pos, len(a))
            if lo < hi:
                parts.append(a[lo:hi, self.first_bin:self.last_bin])
            pos += len(a)
        return np.concatenate(parts, axis=0)

    # ------------------------------------------------------------------
    def _trim(self) -> None:
        """Bound the host-side history ring (the fft1_sumsq ring analog,
        radar.c:144) to ~4 pulse periods."""
        keep = max(4 * max(self.pulse_sep, 1) + self.lines + 64,
                   self.params.lock_after + 64)
        total = sum(len(a) for a in self._hist_pw)
        drop = total - keep
        if drop <= 0:
            return
        # only drop frames already scanned
        drop = min(drop, max(self._next_scan - self._consumed - 16, 0))
        while drop > 0 and self._hist_pw:
            blk = self._hist_pw[0]
            if len(blk) <= drop:
                self._hist_pw.pop(0)
                self._consumed += len(blk)
                del self._bins[: len(blk)]
                del self._ston[: len(blk)]
                del self._floor[: len(blk)]
                drop -= len(blk)
            else:
                self._hist_pw[0] = blk[drop:]
                self._consumed += drop
                del self._bins[:drop]
                del self._ston[:drop]
                del self._floor[:drop]
                drop = 0

    # ------------------------------------------------------------------
    @property
    def average(self) -> np.ndarray:
        """The radar display matrix (lines × display bins)."""
        if self._avg is None:
            return np.zeros((0, 0), np.float32)
        return self._avg.cpu().numpy()

    def range_profile(self) -> np.ndarray:
        """Echo power per display line: the radar display column at the
        pulse bin (what the operator reads range from)."""
        if self._avg is None:
            return np.zeros(0, np.float32)
        return self.average[:, self.pulse_bin - self.first_bin]

    def echo_peak(self, tx_guard_lines: int = 4
                  ) -> tuple[int, int, float | None]:
        """Strongest display cell outside the TX pulse's own rows: the
        echo's (line, bin_offset_from_tx, doppler_hz).  EME echoes are
        doppler-shifted, so the echo appears offset in frequency as well
        as delayed — the radar display is a range x frequency matrix
        (update_radar_average accumulates all bins, radar.c:108-117).
        doppler_hz is None unless ``bin_hz`` was given at construction.
        """
        avg = self.average
        if avg.size == 0:
            return (0, 0, None)
        prof = avg.sum(axis=1)
        tx_line = int(np.argmax(prof > 0.5 * prof.max()))
        masked = avg.copy()
        for p0 in range(tx_line, self.lines,
                        max(self.pulse_sep, 1)):
            lo = max(p0 - tx_guard_lines, 0)
            masked[lo: p0 + tx_guard_lines + 1] = 0.0
        line, b = np.unravel_index(int(np.argmax(masked)), masked.shape)
        off = int(b) - (self.pulse_bin - self.first_bin)
        dopp = off * self.bin_hz if self.bin_hz else None
        # the display spans more than one pulse period, so the same echo
        # repeats after every TX row; report the delay modulo the PRF
        # (the usual radar range ambiguity)
        dl = (int(line) - tx_line) % max(self.pulse_sep, 1)
        return (dl, off, dopp)

    def line_to_range_m(self, line_offset: int) -> float:
        """Convert a line offset from the TX pulse into one-way-ish
        radar range: range = c * t / 2."""
        return SPEED_OF_LIGHT * line_offset * self.frame_time_s / 2.0

    def display_image(self) -> np.ndarray:
        """Intensity-mapped display (make_radar_cfac radar.c:54-59):
        ``10*gain`` dB scaling with a ``zero`` offset, clipped to [0, 1]."""
        p = self.params
        cfac = 10.0 * p.gain
        czer = 0.1 * (p.zero + 1.0)
        img = cfac * 0.05 * (
            np.log10(np.maximum(self.average, 1e-30)) + czer)
        return np.clip(img / 255.0, 0.0, 1.0)
