"""Entry ``radar``: Linrad's radar mode through the port's radar path,
``linrad_tpu_torch.weak.radar.RadarFront.feed(tracker, block)``: the
front (fft1, each frame's power and its pulse statistics, replayed from
one CUDA graph a block) feeding a ``RadarTracker`` (the lock on the pulse
train, the scan and the range x Doppler display, host numpy).  The front
is built as ``RadarFront.of_receiver`` builds it, from an eager
``Receiver`` of the configuration, so that no receiver graph is captured
that the path never replays.

A closed loop of one stream: each block goes in as a host array, and the
next goes in once the tracker has the block's power and statistics on the
host and, after a display update, the display has been fetched
(``tracker.average``, as the operator's screen draws it).

Set-up warms up until the tracker has locked and made
``warmup_updates`` display updates (at most ``warmup_max_blocks``
blocks); the run fails (``setup_lock``) unless the tracker locked on the
traffic's pulse period and its display shows the echo at the traffic's
delay (within a line) and Doppler.

The check: the first ``check.start_blocks`` blocks of set-up, from fresh
states, against the plain reference (``rxbench/reference/weak/radar.py``)
from its own; and ``check.window_samples`` blocks of the window drawn from
the seed, each from the port's state just before it (the front's fft1
state and a copy of the tracker).  The numbers (:func:`block_readings`):
the frames' power, peak bins, S/N off and on the transmitter's frames
(the receiver is muted on those, so that their S/N is a peak over
roundoff), noise floor, the tracker's decisions, the display and the
echo it shows.  A frame whose peak or skirt walk the reference decided
within rounding of a tie gives no peak, S/N or floor reading (it is
counted in the record's ``ties``): two correct float32 fft1s may decide
it apart.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from rxbench import tracing
from rxbench.core import Run
from rxbench.entries.receiver import counted_calls, make_blocks

SPANS = ("radar.h2d", "radar.replay", "radar.owned", "radar.wait",
         "radar.track", "display")
DECISIONS = ("locked", "pulse_sep", "pulse_bin", "lines", "first_bin",
             "last_bin", "update_cnt")


def radar_fields(run: Run) -> dict:
    """The configuration's radar parameters, with a test's overrides."""
    return {**run.config["radar"], **run.size.get("_radar", {})}


def decisions(tracker) -> dict:
    return {k: getattr(tracker, k) for k in DECISIONS}


def kept(tracker, frames: int, display=None) -> dict:
    """What the check compares of the block a port's tracker was just fed
    (``frames`` frames): the frames' power and statistics as the tracker
    holds them, its decisions, the display (``display`` if the caller
    fetched it) and its echo."""
    power = tracker._hist_pw[-1]
    if len(power) != frames:
        raise RuntimeError("rxbench: the tracker's history lost the block "
                           "just fed")
    if display is None and tracker.locked:
        display = tracker.average
    return {"power": power, "peak_bin": np.array(tracker._bins[-frames:]),
            "ston": np.array(tracker._ston[-frames:]),
            "noise_floor": np.array(tracker._floor[-frames:]),
            "decisions": decisions(tracker), "display": display,
            "echo": tracker.echo_peak()[:2] if tracker.locked else None}


class Session:
    def __init__(self, run: Run):
        from linrad_tpu_torch.pipeline.receiver import Receiver
        from linrad_tpu_torch.weak.radar import (RadarFront, RadarParams,
                                                 RadarTracker)
        from rxbench.reference.geometry import derive_geometry
        self.run = run
        t = run.traffic
        self.ref_geo = derive_geometry(run.reference_params())
        self.blocks = make_blocks(run, self.ref_geo, t["dial_hz"])
        run.mark("ring")
        run.note(f"rxbench: ring of {len(self.blocks)} blocks of "
                 f"{self.blocks[0].shape} complex64, "
                 f"{sum(b.nbytes for b in self.blocks)} bytes on the host")
        rx = Receiver(run.program_params(), device=run.device, graphed=False)
        geo = self.geo = rx.geo
        self.front = RadarFront.of_receiver(rx, recorded=counted_calls)
        del rx
        self.tracker = RadarTracker(
            n_bins=geo.fft1_size,
            frame_time_s=geo.fft1_new_points / geo.timf1_sampling_speed,
            bin_hz=geo.timf1_sampling_speed / geo.fft1_size,
            params=RadarParams(**radar_fields(run)), device=run.device)
        run.mark("port")
        self.i = 0
        self.start = [self.kept(self.one())
                      for _ in range(t["check"]["start_blocks"])]
        while (not self.tracker.locked
               or self.tracker.update_cnt < t["warmup_updates"]) \
                and self.i < t["warmup_max_blocks"]:
            self.one()
        self.setup_found = self.found()
        self.samples = []
        self.traced = None

    def found(self) -> tuple[dict, dict]:
        """Whether the tracker locked on the traffic's pulse period and its
        display shows the echo at the traffic's delay (within a line) and
        Doppler: the set-up's reading ``setup_lock``, 0 if so."""
        tr, ring = self.tracker, self.run.ring_spec()
        line, off, dopp = tr.echo_peak() if tr.locked else (None, None, None)
        self.run.note(
            f"rxbench: after {self.i} set-up blocks the tracker locked "
            f"{tr.locked}: pulse separation {tr.pulse_sep} frames, pulse bin "
            f"{tr.pulse_bin}, {tr.update_cnt} display updates; echo at line "
            f"{line}, {off} bins off ({dopp} Hz), "
            f"{tr.line_to_range_m(line or 0) / 1e3:.0f} km")
        ok = (tr.locked and tr.pulse_sep == ring["pulse_period_frames"]
              and tr.update_cnt >= self.run.traffic["warmup_updates"]
              and abs(line - ring["echo_delay_frames"]) <= 1
              and off == ring["echo_doppler_bins"])
        return {"setup_lock": float(not ok)}, {
            "blocks": self.i, "locked": tr.locked,
            "pulse_sep": tr.pulse_sep, "echo": [line, off]}

    def next_block(self) -> np.ndarray:
        b = self.blocks[self.i % len(self.blocks)]
        self.i += 1
        return b

    def one(self):
        """One block through the port; the display, fetched, if the block
        updated it, else None."""
        before = self.tracker.update_cnt
        self.front.feed(self.tracker, self.next_block())
        if self.tracker.update_cnt != before:
            with torch.profiler.record_function("display"):
                return self.tracker.average
        return None

    def kept(self, display) -> dict:
        return kept(self.tracker, self.geo.fft1_frames_per_step, display)

    def snapshot(self) -> dict:
        """The port's state just before a block: the front's fft1 state and
        a copy of the tracker."""
        st = self.front.state
        return {"fft1": (st.tail.detach().clone(),
                         st.sumsq_avg.detach().clone()),
                "tracker": copy.deepcopy(self.tracker)}

    def window(self, seconds: float, times: list) -> dict:
        lat = []
        times = list(times)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            snap = None
            if times and now - t_start >= times[0]:
                times.pop(0)
                snap = self.snapshot()
                index = self.i % len(self.blocks)
            t0 = time.perf_counter()
            display = self.one()
            lat.append(time.perf_counter() - t0)
            if snap is not None:
                self.samples.append((index, snap, self.kept(display)))
        window_s = time.perf_counter() - t_start
        self.run.note(f"rxbench: {self.tracker.update_cnt} display updates "
                      f"after the window, history of "
                      f"{sum(len(a) for a in self.tracker._hist_pw)} frames")
        return {"window_s": window_s, "latencies_s": lat,
                "stream_steps": len(lat),
                "frames": len(lat) * self.ref_geo.samples_per_step}

    def trace_slice(self) -> tracing.Traced:
        n = self.run.traffic["trace_blocks"]
        traced = tracing.Traced()
        updates = self.tracker.update_cnt

        prof, _ = tracing.profile(lambda: [self.one() for _ in range(n)])
        tracing.read_profile(prof, traced, SPANS)
        traced.stream_steps = n
        fft1 = traced.op_seconds("fused_fft1_kernel")
        geo = self.ref_geo
        traced.shapes = {"fft1": (geo.fft1_frames_per_step, geo.fft1_size,
                                  geo.channels)}
        graph = self.front.graph
        traced.notes = (f"fused_fft1 in the trace {len(fft1) / n:.2f} a "
                        f"block, hand kernels a replay "
                        f"{graph.kernels if graph else 0}, "
                        f"{self.tracker.update_cnt - updates} display "
                        f"updates in the slice")
        self.traced = traced
        return traced

    def release(self) -> dict:
        """What the check needs; the port's front and tracker freed."""
        data = {"start": self.start, "samples": self.samples,
                "setup": self.setup_found, "blocks": self.blocks,
                "traced": self.traced}
        self.front = self.tracker = None
        return data


def setup(run: Run) -> Session:
    return Session(run)


def reference_tracker(ref_mod, tracker):
    """The port's tracker (a copy the port no longer feeds) as the
    reference's class: every field, the history, the display on the
    host."""
    params = ref_mod.RadarParams(**vars(tracker.params))
    out = ref_mod.RadarTracker(
        n_bins=tracker.n_bins, frame_time_s=tracker.frame_time_s,
        params=params, bin_hz=tracker.bin_hz)
    for k in DECISIONS + ("decayfac",):
        setattr(out, k, getattr(tracker, k))
    for k in ("_bins", "_ston", "_floor", "_hist_pw", "_consumed",
              "_next_scan"):
        setattr(out, k, getattr(tracker, k))
    out._avg = (None if tracker._avg is None
                else tracker._avg.detach().cpu().numpy())
    return out


def check(run: Run, data: dict) -> list:
    """(kind, readings, details) of every compared block: the start, then
    the window's samples."""
    from rxbench.reference.weak import radar as ref_mod
    dev = torch.device(run.device)
    ref = ref_mod.PlainRadar(run.reference_params(),
                             ref_mod.RadarParams(**radar_fields(run)), dev)
    mute = radar_fields(run)["mute_ratio"]
    blocks = data["blocks"]
    records = [("setup", *data["setup"])]
    for k, got in enumerate(data["start"]):
        want = ref.feed(torch.from_numpy(blocks[k % len(blocks)]).to(dev))
        records.append(("start", *block_readings(got, want, ref.tracker,
                                                 mute, k)))
    for index, snap, got in data["samples"]:
        ref.state = ref_mod.FFT1State(*(t.to(dev) for t in snap["fft1"]))
        ref.tracker = reference_tracker(ref_mod, snap["tracker"])
        want = ref.feed(torch.from_numpy(blocks[index]).to(dev))
        records.append(("window", *block_readings(got, want, ref.tracker,
                                                  mute, index)))
    return records


def rows_rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest over rows of max |got - want| / max |want| in the row;
    inf where a shape differs or the port reads NaN."""
    if got is None or want is None or got.shape != want.shape:
        return math.inf
    if got.size == 0:
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    gap = np.abs(g - w).max(axis=1)
    scale = np.abs(w).max(axis=1)
    rel = np.where(scale > 0, gap / np.where(scale > 0, scale, 1.0), gap)
    return float(rel.max()) if np.isfinite(rel).all() else math.inf


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / |want| over the frames given (0 for none)."""
    if not len(want):
        return 0.0
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return float(rel.max()) if np.isfinite(rel).all() else math.inf


def block_readings(got: dict, want: dict, ref_tracker, mute: float,
                   index: int) -> tuple[dict, dict]:
    """The readings of one block and what identifies it.  The transmitter's
    frames are those whose reference noise floor lies under ``mute`` (the
    tracker's own mute bound) times the block's median: the receiver is
    muted there."""
    from rxbench.reference.weak.radar import TIE
    floor = want["noise_floor"]
    tx = floor < mute * np.median(floor)
    peak_tie = want["peak_margin"] < TIE
    tie = peak_tie | (~tx & (want["walk_margin"] < TIE))
    judged = ~tie
    quiet = judged & ~tx
    nums = {
        "power": rows_rel(got["power"], want["power"]),
        "peak_bins": float(np.sum((got["peak_bin"] != want["peak_bin"])
                                  & ~peak_tie)),
        "ston": rel_gap(got["ston"][quiet], want["ston"][quiet]),
        "ston_tx": rel_gap(got["ston"][tx], want["ston"][tx]),
        "noise_floor": rel_gap(got["noise_floor"][quiet], floor[quiet]),
    }
    mine = decisions(ref_tracker)
    nums["tracker"] = float(sum(got["decisions"][k] != v
                                for k, v in mine.items()))
    if ref_tracker.locked or got["display"] is not None:
        nums["display"] = rows_rel(got["display"], ref_tracker.average
                                   if ref_tracker.locked else None)
        nums["echo"] = float(not ref_tracker.locked or got["echo"] is None
                             or tuple(got["echo"])
                             != ref_tracker.echo_peak())
    return nums, {"block": index, "tx_frames": int(tx.sum()),
                  "ties": int(tie.sum()),
                  "port_updates": got["decisions"]["update_cnt"],
                  "ref_updates": mine["update_cnt"]}
