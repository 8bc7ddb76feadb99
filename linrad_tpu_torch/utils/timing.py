"""Timing on the card: eager calls between CUDA events, device-only time
from a CUDA graph replay, and the step and stage timers of
linrad_tpu/utils/timing.py.

The reference accounts per-thread CPU time at about 1 Hz
(thread_workload[], menu.c:914-957; the T-display, timing.c:361).  Here
:class:`StepTimer` measures a step's wall time up to the device having
finished it and reports samples/s and the real-time factor, the numbers
that replace the on-screen workload percentages; the stages' cost is
the tracer's (``utils/trace.py``: a span per stage of the step, and a
device time per stage of a graph captured with its device intervals on).
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
