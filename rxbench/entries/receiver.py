"""Entry ``receiver``: a recording replayed through
``linrad_tpu_torch.pipeline.receiver.Receiver.process_block`` as fast as
the card takes it (what ``Receiver.run`` does, and how Linrad processes a
file).  Each block goes in as a host numpy array and its audio comes back
to the host (``out.audio.cpu()``), as a live consumer takes it, before the
next block goes in: a closed loop of one stream.

The check: the first ``check.start_blocks`` blocks of set-up, from the
receiver's fresh state, against the plain reference from its own fresh
state; and ``check.window_samples`` blocks of the window, drawn from the
seed, each against one plain step from the port's state, tuning and AFC
just before that block (the reference cannot follow thousands of steps
within the run's time).  With an AFC, its status and tuning after each
compared block are compared too.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from rxbench import compare, tracing
from rxbench.core import Run, torch_generator
from rxbench.roofline import blanker_fits as fits_roof
from rxbench.roofline import sellim_taper as taper_roof

SPANS = ("h2d", "enqueue", "owned", "control", "fetch")


def counted_calls() -> int:
    """The port's hand-kernel calls recorded into CUDA graphs so far."""
    from linrad_tpu_torch.ops.blanker import fits_count
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.ops.sellim import taper_count
    return fused_fft1.captured + fits_count.captured + taper_count.captured


def outputs(out) -> dict:
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def tuning(rx) -> tuple:
    return tuple(None if t is None else t.detach().clone()
                 for t in (rx._tune_bin, rx._tune_frac, rx._tune_slope))


def make_blocks(run: Run, geo, dial_hz: float, salt: int = 0) -> list:
    """The ring of distinct blocks, made from the seed: host arrays."""
    x = run.generator().make_ring(
        geo, run.ring_spec(), torch_generator(run.seed, run.device, 1, salt),
        dial_hz)
    if run.device.startswith("cuda"):
        # the ring was made on the card and is on the host now: the peak
        # memory the run reports is the port's
        torch.cuda.reset_peak_memory_stats()
    s = geo.samples_per_step
    return [x[i * s:(i + 1) * s] for i in range(x.shape[0] // s)]


class Session:
    def __init__(self, run: Run):
        from linrad_tpu_torch.pipeline.receiver import Receiver
        from rxbench.reference.geometry import derive_geometry
        self.run = run
        t = run.traffic
        self.ref_geo = derive_geometry(run.reference_params())
        self.blocks = make_blocks(run, self.ref_geo, t["dial_hz"])
        run.mark("ring")
        run.note(f"rxbench: ring of {len(self.blocks)} blocks of "
                 f"{self.blocks[0].shape} complex64, "
                 f"{sum(b.nbytes for b in self.blocks)} bytes on the host")
        self.rx = Receiver(run.program_params(), device=run.device,
                           recorded=counted_calls)
        self.rx.tune(t["dial_hz"])
        run.mark("port")
        self.i = 0
        self.start = []
        for _ in range(t["check"]["start_blocks"]):
            out = self.rx.process_block(self.next_block())
            self.start.append((outputs(out), *self.after()))
        lock = t.get("lock_status")
        most = t.get("warmup_max_blocks", t["warmup_blocks"])
        while self.i < t["warmup_blocks"] or (
                lock is not None and self.rx.afc.status != lock
                and self.i < most):
            self.rx.process_block(self.next_block())
        if lock is not None:
            run.note(f"rxbench: AFC status {self.rx.afc.status} after "
                     f"{self.i} warm-up blocks (statuses of the checked "
                     f"start: {[s[1] for s in self.start]})")
        self.spans = tracing.Spans() if run.trace else None
        self.saved = {}
        if self.spans is not None:
            self._wrap()

    def next_block(self) -> np.ndarray:
        b = self.blocks[self.i % len(self.blocks)]
        self.i += 1
        return b

    def after(self) -> tuple:
        afc = self.rx.afc
        return (None if afc is None else afc.status), tuning(self.rx)

    def snapshot(self) -> dict:
        """The port's state, tuning and control just before a block."""
        from linrad_tpu_torch.pipeline.batch import tensor_leaves
        c = self.rx.control
        return {"state": [t.detach().clone()
                          for t in tensor_leaves(self.rx.state)],
                "tuning": tuning(self.rx),
                "afc": copy.deepcopy(c.afc),
                "subbuf": copy.deepcopy(c._afc_subbuf),
                "steps_done": c.steps_done}

    def _wrap(self) -> None:
        """The spans: module functions and this receiver's methods wrapped
        where ``process_block`` calls them."""
        from linrad_tpu_torch.pipeline import receiver as mod
        sp = self.spans
        self.saved = {"_as_block": mod._as_block, "_owned": mod._owned}
        mod._as_block = sp.wrap("h2d", mod._as_block)
        mod._owned = sp.wrap("owned", mod._owned)
        self.rx._advance = sp.wrap("enqueue", self.rx._advance)
        self.rx.control.update = sp.wrap("control", self.rx.control.update,
                                         sync_first=self.run.device
                                         .startswith("cuda"))

    def _unwrap(self) -> None:
        from linrad_tpu_torch.pipeline import receiver as mod
        for name, fn in self.saved.items():
            setattr(mod, name, fn)
        self.saved = {}

    def one(self):
        """One block through the port and its audio to the host."""
        out = self.rx.process_block(self.next_block())
        if self.spans is None:
            out.audio.cpu()
        else:
            with torch.profiler.record_function("fetch"):
                t = time.perf_counter()
                out.audio.cpu()
                self.spans.open["fetch"] += time.perf_counter() - t
        return out

    def window(self, seconds: float, times: list) -> dict:
        lat, samples, host, statuses = [], [], [], {}
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
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if self.rx.afc is not None:
                st = self.rx.afc.status
                statuses[st] = statuses.get(st, 0) + 1
            if self.spans is not None:
                host.append((t1 - t0, self.spans.take()))
            if snap is not None:
                samples.append((index, snap, outputs(out), *self.after()))
        window_s = time.perf_counter() - t_start
        if statuses:
            self.run.note(f"rxbench: AFC status after each window block: "
                          f"{statuses} (status: blocks)")
        self.samples = samples
        self.host = host
        return {"window_s": window_s, "latencies_s": lat,
                "stream_steps": len(lat),
                "frames": len(lat) * self.ref_geo.samples_per_step}

    def trace_slice(self) -> tracing.Traced:
        n = self.run.traffic["trace_blocks"]
        traced = tracing.Traced()
        wall = np.array([w for w, _ in self.host])
        wait = np.array([s.get("wait", 0.0) for _, s in self.host])
        ctrl = np.array([s.get("control", 0.0) for _, s in self.host])
        if len(wall):
            traced.host = {"driver": float(np.mean(wall - wait - ctrl)),
                           "control": float(np.mean(ctrl))}
        prof, fitted = tracing.profile(
            lambda: [self.one().blanker_fitted for _ in range(n)])
        self.spans.take()
        tracing.read_profile(prof, traced, SPANS)
        traced.stream_steps = n
        hand = traced.op_seconds("fused_fft1_kernel", "blanker_fits_kernel",
                                 "sellim_taper_kernel")
        traced.notes = (f"hand kernels in the trace {len(hand) / n:.2f} a "
                        f"block, kernels_per_replay "
                        f"{self.rx.kernels_per_replay}")
        geo = self.ref_geo
        traced.counts = {
            "fits": [int(f) for f in torch.stack(fitted).cpu()]
            if fitted and fitted[0] is not None else []}
        traced.shapes = {
            "fft1": (geo.fft1_frames_per_step, geo.fft1_size, geo.channels),
            "fits": fits_roof.shape(
                geo, self.run.config["params"]["blanker_block_size"], 1),
            "taper": (1, geo.fft1_size)}
        self.traced = traced
        return traced

    def release(self) -> dict:
        """What the check needs; the port's receiver and graphs freed."""
        self._unwrap()
        data = {"start": self.start, "samples": getattr(self, "samples", []),
                "blocks": self.blocks, "fftx_size": self.rx.geo.fftx_size,
                "traced": getattr(self, "traced", None)}
        self.rx = None
        return data


def setup(run: Run) -> Session:
    return Session(run)


def afc_state(ref_afc_cls, ref_cfg_cls, geo, afc) -> object:
    """The port's AFC tracker as the reference's class (every field
    copied, the geometry and configuration the reference's own)."""
    fields = {f.name: copy.deepcopy(getattr(afc, f.name))
              for f in dataclasses.fields(afc) if f.name not in
              ("geo", "config")}
    cfg = ref_cfg_cls(**dataclasses.asdict(afc.config))
    return ref_afc_cls(geo=geo, config=cfg, **fields)


def check(run: Run, data: dict) -> list:
    """(kind, readings) of every compared block: the start, then the
    window's samples."""
    from rxbench.reference.receiver import PlainReceiver, with_leaves
    from rxbench.reference.weak.afc import AFCConfig, AFCTracker
    params = run.reference_params()
    dev = torch.device(run.device)
    n = data["fftx_size"]
    traced = data["traced"]
    taper_ops = []
    if traced is not None:
        import rxbench.reference.ops.sellim as ref_sellim
        plain = ref_sellim.sellim_taper

        def counting(lim, budget):
            taper_ops.append(taper_roof.operations(lim, budget))
            return plain(lim, budget)

        ref_sellim.sellim_taper = counting
    try:
        records = []
        ref = PlainReceiver(params, dev)
        ref.tune(run.traffic["dial_hz"])
        for k, (got, status, tune) in enumerate(data["start"]):
            want = ref.process_block(torch.from_numpy(
                data["blocks"][k % len(data["blocks"])]).to(dev))
            records.append(("start", *block_readings(
                got, outputs(want), ref, status, tune, n, k)))
        template = ref.state
        for index, snap, got, status, tune in data["samples"]:
            ref.state = with_leaves(template,
                                    [t.to(dev) for t in snap["state"]])
            ref.tune_bin, ref.tune_frac, ref.tune_slope = (
                None if t is None else t.to(dev) for t in snap["tuning"])
            c = ref.control
            if snap["afc"] is not None:
                c.afc = afc_state(AFCTracker, AFCConfig, ref.geo,
                                  snap["afc"])
            c._afc_subbuf = copy.deepcopy(snap["subbuf"])
            c.steps_done = snap["steps_done"]
            want = ref.process_block(torch.from_numpy(
                data["blocks"][index]).to(dev))
            records.append(("window", *block_readings(
                got, outputs(want), ref, status, tune, n, index)))
    finally:
        if traced is not None:
            ref_sellim.sellim_taper = plain
    if traced is not None and taper_ops:
        traced.counts["taper_ops"] = float(np.mean(taper_ops))
    return records


def block_readings(got: dict, want: dict, ref, status, tune, n,
                   index: int) -> tuple[dict, dict]:
    """The readings of one block, and what identifies it."""
    nums = compare.step_numbers(got, want)
    if ref.control.afc is not None:
        nums["afc_status"] = float(status != ref.control.afc.status)
        nums["afc_tune"] = compare.tuning_gap(
            tune, (ref.tune_bin, ref.tune_frac, ref.tune_slope), n)
    return nums, {"block": index, **compare.counts(got, want)}
