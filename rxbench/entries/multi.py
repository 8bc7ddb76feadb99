"""Entry ``multi``: one wideband stream through
``linrad_tpu_torch.pipeline.receiver.MultiReceiver.process_block``: one
front end feeding the configuration's ``sub_receivers`` narrowband
sub-receivers (replayed from one CUDA graph on the card), each tuned to a
station the traffic's generator lays out (``sub_receiver_hz``).  Each
block goes in as a host numpy array and all the sub-receivers' audio
comes back to the host (``out.audio.cpu()``) before the next block goes
in: a closed loop of one stream.  ``frames`` counts the stream's samples
once a block, not once a sub-receiver.

The check: the first ``check.start_blocks`` blocks of set-up, from fresh
states, against the plain reference (``rxbench/reference/multi.py``) from
its own; and ``check.window_samples`` blocks of the window, drawn from the
seed, each against one plain step from the port's wideband state, stacked
narrowband states and tuning just before that block.  The wideband fields
are read as ``compare.py`` reads a receiver's; the narrowband ones
(audio, baseband, AGC gain) sub-receiver by sub-receiver, each against its
own largest magnitude, the largest gap over the sub-receivers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rxbench import compare, tracing
from rxbench.core import Run, torch_generator
from rxbench.entries.receiver import make_blocks

SPANS = ("multi.h2d", "multi.replay", "multi.owned", "multi.step", "fetch")
WIDE = ("fft1_avg_power", "fft2_power", "liminfo", "blanker_fitted",
        "blanker_cleared")
FIELDS = compare.NARROWBAND + WIDE


def tunings(run: Run, geo) -> np.ndarray:
    """The K sub-receivers' frequencies: the generator's layout, drawn from
    a generator seeded as the ring's (``make_blocks``)."""
    hz = run.generator().sub_receiver_hz(
        geo, run.ring_spec(), torch_generator(run.seed, run.device, 1, 0))
    k = run.config["sub_receivers"]
    if len(hz) < k:
        raise ValueError(f"rxbench: the traffic lays out {len(hz)} stations "
                         f"for {k} sub-receivers")
    return np.asarray(hz[:k], np.float64)


def kept(out) -> dict:
    """The compared fields of one block's outputs."""
    return {f: getattr(out, f) for f in FIELDS}


def hand_calls() -> int:
    """Every hand kernel's calls recorded into CUDA graphs so far (the
    receiver entry's count takes three of them; the band's step also runs
    blanker_clear and sellim_update)."""
    from linrad_tpu_torch.utils import cuda_build
    return sum(c.captured for c in cuda_build.COUNTS.values())


class Session:
    def __init__(self, run: Run):
        from linrad_tpu_torch.pipeline.receiver import MultiReceiver
        from rxbench.reference.geometry import derive_geometry
        self.run = run
        t = run.traffic
        geo = self.ref_geo = derive_geometry(run.reference_params())
        self.blocks = make_blocks(run, geo, t["dial_hz"])
        self.hz = tunings(run, geo)
        run.mark("ring")
        run.note(f"rxbench: ring of {len(self.blocks)} blocks of "
                 f"{self.blocks[0].shape} complex64, "
                 f"{sum(b.nbytes for b in self.blocks)} bytes on the host; "
                 f"{len(self.hz)} sub-receivers from {self.hz[0]:.1f} to "
                 f"{self.hz[-1]:.1f} Hz")
        self.rx = MultiReceiver(run.program_params(), len(self.hz),
                                device=run.device, recorded=hand_calls)
        for k, hz in enumerate(self.hz):
            self.rx.tune_subch(k, float(hz))
        run.mark("port")
        self.i = 0
        self.start = [kept(self.rx.process_block(self.next_block()))
                      for _ in range(t["check"]["start_blocks"])]
        while self.i < t["warmup_blocks"]:
            self.rx.process_block(self.next_block())
        self.samples = []
        self.traced = None

    def next_block(self) -> np.ndarray:
        b = self.blocks[self.i % len(self.blocks)]
        self.i += 1
        return b

    def snapshot(self) -> dict:
        """The port's wideband state, stacked narrowband states and tuning
        just before a block."""
        from linrad_tpu_torch.pipeline.batch import tensor_leaves
        return {"state": [t.detach().clone()
                          for t in tensor_leaves(self.rx.state)],
                "nbs": [t.detach().clone()
                        for t in tensor_leaves(self.rx.nbs)],
                "tune_bins": self.rx._tune_bins.detach().clone()}

    def one(self, profiled: bool = False):
        """One block through the port and every sub-receiver's audio to the
        host (under the profiler, in a range ``fetch``)."""
        out = self.rx.process_block(self.next_block())
        if profiled:
            with torch.profiler.record_function("fetch"):
                out.audio.cpu()
        else:
            out.audio.cpu()
        return out

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
            out = self.one()
            lat.append(time.perf_counter() - t0)
            if snap is not None:
                self.samples.append((index, snap, kept(out)))
        window_s = time.perf_counter() - t_start
        return {"window_s": window_s, "latencies_s": lat,
                "stream_steps": len(lat),
                "frames": len(lat) * self.ref_geo.samples_per_step}

    def trace_slice(self) -> tracing.Traced:
        from linrad_tpu_torch.utils import trace
        n = self.run.traffic["trace_blocks"]
        traced = tracing.Traced()
        before = trace.counters.get("subrx_blocks")
        prof, _ = tracing.profile(
            lambda: [self.one(True) for _ in range(n)])
        tracing.read_profile(prof, traced, SPANS)
        traced.stream_steps = n
        traced.shapes = {"update": (1, self.ref_geo.fft1_size)}
        counted = ("not counted" if before is None else
                   trace.counters["subrx_blocks"] - before)
        hand = traced.op_seconds("blanker_fits_kernel", "sellim_taper_kernel",
                                 "sellim_front_kernel", "sellim_back_kernel",
                                 "blanker_clear")
        dev_ms = 1e3 * sum(t for _op, t in traced.ops) / n
        traced.notes = (f"device operations {len(traced.ops) / n:.2f} and "
                        f"device ms {dev_ms:.4f} a block, hand kernels in "
                        f"the trace "
                        f"{len(hand) / n:.2f} a block, kernels_per_replay "
                        f"{self.rx.kernels_per_replay}, subrx_blocks "
                        f"{counted} in {n} blocks")
        self.traced = traced
        return traced

    def release(self) -> dict:
        """What the check needs; the port's receiver and graph freed."""
        data = {"start": self.start, "samples": self.samples,
                "blocks": self.blocks, "hz": self.hz,
                "traced": self.traced}
        self.rx = None
        return data


def setup(run: Run) -> Session:
    return Session(run)


def check(run: Run, data: dict) -> list:
    """(kind, readings, details) of every compared block: the start, then
    the window's samples."""
    from rxbench.reference.multi import PlainMultiReceiver
    from rxbench.reference.receiver import with_leaves
    dev = torch.device(run.device)
    ref = PlainMultiReceiver(run.reference_params(), len(data["hz"]), dev)
    for k, hz in enumerate(data["hz"]):
        ref.tune_subch(k, float(hz))
    blocks = data["blocks"]
    records = []
    for k, got in enumerate(data["start"]):
        want = ref.process_block(torch.from_numpy(
            blocks[k % len(blocks)]).to(dev))
        records.append(("start", *block_readings(got, kept(want), k)))
    state, nbs = ref.state, ref.nbs
    for index, snap, got in data["samples"]:
        ref.state = with_leaves(state, [t.to(dev) for t in snap["state"]])
        ref.nbs = with_leaves(nbs, [t.to(dev) for t in snap["nbs"]])
        ref.tune_bins = snap["tune_bins"].to(dev)
        want = ref.process_block(torch.from_numpy(blocks[index]).to(dev))
        records.append(("window", *block_readings(got, kept(want), index)))
    return records


def block_readings(got: dict, want: dict, index: int) -> tuple[dict, dict]:
    """The readings of one block: the wideband fields as a receiver's, each
    narrowband field the largest over the sub-receivers of its gap
    relative to that sub-receiver's largest magnitude; and what identifies
    the block."""
    nums = compare.step_numbers(got, {f: want[f] for f in WIDE})
    for f in compare.NARROWBAND:
        g, w = got[f], want[f]
        nums[f] = (max(compare.max_rel(g[k], w[k]) for k in range(len(w)))
                   if tuple(g.shape) == tuple(w.shape) else float("inf"))
    return nums, {"block": index, **compare.counts(got, want)}
