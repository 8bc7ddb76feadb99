"""Timing on the card: eager calls between CUDA events, device-only time
from a CUDA graph replay, and the step and stage timers of
linrad_tpu/utils/timing.py.

The reference accounts per-thread CPU time at about 1 Hz
(thread_workload[], menu.c:914-957; the T-display, timing.c:361).  Here
:class:`StepTimer` measures a step's wall time up to the device having
finished it and reports samples/s and the real-time factor, the numbers
that replace the on-screen workload percentages; :func:`profile_stages`
attributes cost to named stages.

As a script it times ``fused_fft1`` of this checkout, or of this
checkout and another on the same card in turns (other, this, this,
other), for comparing two versions of the kernel:

    python3 linrad_tpu_torch/utils/timing.py [--other DIR]

DIR holds another ``linrad_tpu_torch`` package; each checkout is loaded
in a process of its own, since both packages have the same name.  Every
line printed carries the card's name and power limit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


def _finish(*tensors) -> None:
    """Wait until the device has produced the given CUDA tensors."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class StepTimer:
    """Collects per-step timings; use around the step call."""

    sample_rate: float
    samples_per_step: int
    _times: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *tensors) -> float:
        _finish(*tensors)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        return dt

    @property
    def mean_step_s(self) -> float:
        t = self._times[1:] or self._times  # skip the warm-up step
        return sum(t) / max(len(t), 1)

    @property
    def samples_per_second(self) -> float:
        return self.samples_per_step / max(self.mean_step_s, 1e-12)

    @property
    def realtime_factor(self) -> float:
        """>1 means faster than the A/D produces samples (the headroom
        the reference's workload % expresses inversely)."""
        return self.samples_per_second / self.sample_rate

    def report(self) -> dict:
        return {
            "steps": len(self._times),
            "mean_step_ms": 1e3 * self.mean_step_s,
            "msamples_per_s": self.samples_per_second / 1e6,
            "realtime_factor": self.realtime_factor,
        }


def profile_stages(fns: dict, repeats: int = 10) -> dict:
    """Time a dict of name -> zero-arg callables returning a tensor or a
    tuple of tensors (per-stage cost attribution, the per-thread CPU%
    analog): seconds per call, the device's work included."""
    out = {}
    for name, fn in fns.items():
        r = fn()  # warm-up
        _finish(*(r if isinstance(r, (tuple, list)) else (r,)))
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = fn()
        _finish(*(r if isinstance(r, (tuple, list)) else (r,)))
        out[name] = (time.perf_counter() - t0) / repeats
    return out


def cuda_ms(fn, reps: int) -> float:
    """ms per eager call of fn: reps calls between two CUDA events.  The
    host's cost of enqueueing the call is in it wherever the host, not
    the card, is the slower of the two."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int, replays: int) -> float:
    """Device-only ms per call of fn: `calls` calls captured into one CUDA
    graph on a side stream (after warm-up calls on that stream, so that
    caches, FFT plans and a kernel's scratch exist before the capture)
    and replayed `replays` times between CUDA events.  No host work lies
    between the captured kernels.  Replays meet the same inputs, so an
    input that fits the 50 MB L2 cache is read from there."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


SHAPES = [(64, 2048, 1), (64, 4096, 2), (2048, 2048, 1)]


def _time_checkout(root: str) -> None:
    """Time fused_fft1 of the package under root at SHAPES; one line per
    shape."""
    import subprocess
    import sys

    import numpy as np
    sys.path.insert(0, root)
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for b, n, c in SHAPES:
        rng = np.random.default_rng(7)
        frames = torch.from_numpy(
            (rng.normal(size=(b, n, c)) + 1j * rng.normal(size=(b, n, c))
             ).astype(np.complex64)).cuda()
        window = torch.from_numpy((np.sin(np.pi * (np.arange(n) + 0.5) / n)
                                   ** 2).astype(np.float32)).cuda()
        fc = torch.from_numpy(
            ((rng.normal(size=(n, c)) + 1j * rng.normal(size=(n, c))) * 0.1
             ).astype(np.complex64)).cuda()

        def kernel():
            return fused_fft1(frames, window, fc)

        reps = 50 if b * n <= 1 << 17 else 10
        for _ in range(3):
            kernel()
        eager = [cuda_ms(kernel, reps) for _ in range(4)]
        device = [graph_ms(kernel, reps, 20 if reps == 50 else 5)
                  for _ in range(2)]
        print(f"{root}: fused_fft1 {(b, n, c)}: device_ms "
              f"{min(device):.5f}-{max(device):.5f}, eager ms "
              f"{min(eager):.4f}-{max(eager):.4f} [{smi}]", flush=True)


def main() -> None:
    import argparse
    import subprocess
    import sys
    from pathlib import Path
    here = str(Path(__file__).resolve().parents[2])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--other", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _time_checkout(args.one)
        return
    if not torch.cuda.is_available():
        raise SystemExit("timing: torch.cuda.is_available() is False")
    roots = [here] if args.other is None else [
        args.other, here, here, args.other]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
