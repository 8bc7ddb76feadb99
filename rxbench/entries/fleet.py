"""Entry ``fleet``: many receivers on one card through
``linrad_tpu_torch.parallel.fleet.FleetRunner.process``, K steps of R
streams a call (the vmapped step replayed K times from a CUDA graph), each
stream a ring of its own on its own dial; every call's collected fields,
the audio among them, come back to the host before the next call goes in.

The check: the first ``check.start_steps`` steps of the first call, from
the fleet's fresh state, and the first ``check.sample_steps`` steps of
``check.window_samples`` calls of the window drawn from the seed, from the
port's state just before that call; every stream against the plain
reference receiver, stream by stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rxbench import compare, tracing
from rxbench.core import Run
from rxbench.entries.receiver import counted_calls, make_blocks, outputs
from rxbench.roofline import blanker_fits as fits_roof


class Session:
    def __init__(self, run: Run):
        from linrad_tpu_torch.parallel.fleet import FleetRunner
        from rxbench.reference.geometry import derive_geometry
        self.run = run
        t = run.traffic
        self.r, self.k = t["streams"], t["k_steps"]
        geo = self.ref_geo = derive_geometry(run.reference_params())
        # (R, steps, S, C): stream j's ring from the seed, on its dial
        self.rings = np.stack([np.stack(make_blocks(run, geo, dial, j))
                               for j, dial in enumerate(t["dials_hz"])])
        run.mark("ring")
        run.note(f"rxbench: rings of {self.rings.shape} complex64 (streams, "
                 f"blocks, samples, channels), {self.rings.nbytes} bytes on "
                 f"the host")
        self.fleet = FleetRunner(run.program_params(), self.r, self.k,
                                 outputs=tuple(t["outputs"]),
                                 device=run.device, recorded=counted_calls)
        self.fleet.tune(t["dials_hz"])
        run.mark("port")
        self.calls = self.rings.shape[1] // self.k
        self.c = 0
        self.start = self.one()
        for _ in range(t["warmup_calls"]):
            self.one()
        self.samples = []
        self.traced = None

    def chunk(self, c: int) -> np.ndarray:
        """Call c's input: (R, K S, C), K blocks of each stream."""
        j = c % self.calls
        x = self.rings[:, j * self.k:(j + 1) * self.k]
        return x.reshape(self.r, -1, x.shape[-1])

    def one(self) -> dict:
        out = self.fleet.process(self.chunk(self.c))
        self.c += 1
        return out

    def window(self, seconds: float, times: list) -> dict:
        from linrad_tpu_torch.pipeline.batch import tensor_leaves
        calls = 0
        times = list(times)
        lat = []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            snap = None
            if times and now - t_start >= times[0]:
                times.pop(0)
                snap = ([x.detach().clone()
                         for x in tensor_leaves(self.fleet.state)], self.c)
            t0 = time.perf_counter()
            out = self.one()
            lat.append(time.perf_counter() - t0)
            calls += 1
            if snap is not None:
                self.samples.append((*snap, out))
        window_s = time.perf_counter() - t_start
        for _ in times:
            # a window shorter than its sample times (a slow host: a call
            # takes a second on a CPU) keeps them after it has closed
            snap = ([x.detach().clone()
                     for x in tensor_leaves(self.fleet.state)], self.c)
            self.samples.append((*snap, self.one()))
        steps = calls * self.k * self.r
        self.run.note(f"rxbench: {calls} fleet calls of {self.k} steps x "
                      f"{self.r} streams, ms a call median "
                      f"{1e3 * float(np.median(lat)) if lat else 0:.4f}")
        return {"window_s": window_s, "latencies_s": [],
                "stream_steps": steps,
                "frames": steps * self.ref_geo.samples_per_step}

    def trace_slice(self) -> tracing.Traced:
        n = self.run.traffic["trace_calls"]
        traced = tracing.Traced()

        def calls():
            outs = []
            for _ in range(n):
                with torch.profiler.record_function("fleet_call"):
                    outs.append(self.one())
            return outs

        prof, outs = tracing.profile(calls)
        tracing.read_profile(prof, traced, ("fleet_call",))
        geo = self.ref_geo
        traced.stream_steps = n * self.k * self.r
        hand = traced.op_seconds("fused_fft1_kernel", "blanker_fits_kernel",
                                 "sellim_taper_kernel")
        per_replay = len(hand) / (n * self.k)
        traced.notes = (f"hand kernels in the trace {per_replay:.2f} a "
                        f"replay, kernels_per_replay "
                        f"{self.fleet.kernels_per_replay}")
        fits = []
        for o in outs:
            if "blanker_fitted" in o:
                per = np.asarray(o["blanker_fitted"]).reshape(self.r, self.k)
                fits.extend(int(v) for v in per.sum(axis=0))
        traced.counts = {"fits": fits}
        traced.shapes = {
            "fft1": (geo.fft1_frames_per_step, geo.fft1_size,
                     geo.channels * self.r),
            "fits": fits_roof.shape(
                geo, self.run.config["params"]["blanker_block_size"], self.r),
            "taper": (self.r, geo.fft1_size)}
        self.traced = traced
        return traced

    def release(self) -> dict:
        data = {"start": (None, 0, self.start), "samples": self.samples,
                "rings": self.rings, "r": self.r, "k": self.k,
                "traced": self.traced}
        self.fleet = None
        return data


def setup(run: Run) -> Session:
    return Session(run)


def stream_step(out: dict, r: int, k: int, rr: int, kk: int) -> dict:
    """Stream rr's fields at step kk of a call's collected outputs, flat."""
    return {f: np.asarray(v).reshape(r, k, -1)[rr, kk]
            for f, v in out.items()}


def check(run: Run, data: dict) -> list:
    """(kind, readings) of every compared stream-step."""
    from rxbench.reference.receiver import (PlainReceiver, fleet_tuning,
                                            tensor_leaves, with_leaves)
    t = run.traffic
    dev = torch.device(run.device)
    r, k = data["r"], data["k"]
    ref = PlainReceiver(run.reference_params(), dev)
    bins, fracs = fleet_tuning(ref.geo, t["dials_hz"])
    fresh = ref.state
    cases = [("start", data["start"], t["check"]["start_steps"])]
    cases += [("window", s, t["check"]["sample_steps"])
              for s in data["samples"]]
    records = []
    for kind, (leaves, c, got), steps in cases:
        j = c % (data["rings"].shape[1] // k)
        for rr in range(r):
            ref.state = with_leaves(fresh, [
                x.clone() for x in tensor_leaves(fresh)] if leaves is None
                else [x[rr].to(dev) for x in leaves])
            ref.tune_bin = torch.tensor(int(bins[rr]), device=dev)
            ref.tune_frac = torch.tensor(float(fracs[rr]),
                                         dtype=torch.float32, device=dev)
            for kk in range(steps):
                block = data["rings"][rr, j * k + kk]
                want = outputs(ref.process_block(
                    torch.from_numpy(block).to(dev)))
                want = {f: v.reshape(-1) for f, v in want.items()
                        if f in got and v is not None}
                mine = stream_step(got, r, k, rr, kk)
                records.append((kind, compare.step_numbers(mine, want),
                                {"call": c, "stream": rr, "step": kk,
                                 **compare.counts(mine, want)}))
    return records
