"""Host spans around the calls into the port's layers, and the reading of
a ``torch.profiler`` slice: device busy time, idle gaps by the host span
they fell in, device operations by name.

The spans are taken from the benchmark's own files: each wraps a call
into the port (a module function, a method of one object) and is named
by the layer it enters.  In the profiled slice each span is also a
``record_function`` range, so the host's spans and the device's
operations share one clock.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


class Spans:
    """Seconds spent in each named span since the last :meth:`take`."""

    def __init__(self):
        self.open = defaultdict(float)

    def wrap(self, name: str, fn, sync_first: bool = False):
        """``fn`` timed as span ``name``; with ``sync_first`` the device is
        synchronised first and that wait is counted as ``wait``."""

        def timed(*args, **kwargs):
            if sync_first:
                t = time.perf_counter()
                torch.cuda.synchronize()
                self.open["wait"] += time.perf_counter() - t
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                result = fn(*args, **kwargs)
            self.open[name] += time.perf_counter() - t
            return result

        return timed

    def take(self) -> dict:
        out = dict(self.open)
        self.open.clear()
        return out


@dataclass
class Traced:
    """What the traced run read: the per-layer metrics' input."""

    stream_steps: int = 0             # in the profiled slice
    window_s: float = 0.0             # the slice's wall time
    busy_s: float = 0.0               # union of the device's busy intervals
    ops: list = field(default_factory=list)    # (name, seconds) each
    host: dict = field(default_factory=dict)   # span -> seconds per block
    counts: dict = field(default_factory=dict)  # the entry's counters
    shapes: dict = field(default_factory=dict)  # kernel shapes, for bounds
    breakdown: dict = field(default_factory=dict)
    notes: str = ""

    def op_seconds(self, *fragments: str) -> list[float]:
        """Durations of the device operations whose name holds any of
        ``fragments``."""
        return [s for name, s in self.ops
                if any(f in name for f in fragments)]


def profile(run_slice) -> tuple:
    """``run_slice()`` under the profiler, inside a range named
    ``slice``; returns (profiler, run_slice's result)."""
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("slice"):
            result = run_slice()
            if cuda:
                torch.cuda.synchronize()
    return prof, result


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_profile(prof, traced: Traced, span_names: tuple) -> None:
    """Fill ``traced`` from the profiler: the device's operations inside
    the slice, its busy time, and the idle gaps named by the host span
    (of ``span_names``) their midpoint fell in."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = []
    dev = []
    lo = hi = None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                dev.append((name, e.start_ns(), e.end_ns()))
        elif name == "slice":
            lo, hi = e.start_ns(), e.end_ns()
        elif name in span_names:
            host.append((e.start_ns(), e.end_ns(), name))
    if lo is None:
        raise RuntimeError("rxbench: the profiler recorded no slice range")
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    traced.window_s = (hi - lo) * 1e-9
    traced.ops = [(n, (b - a) * 1e-9) for n, a, b in dev]
    busy = _merge([(a, b) for _n, a, b in dev])
    traced.busy_s = sum(b - a for a, b in busy) * 1e-9
    by_op = defaultdict(float)
    for n, s in traced.ops:
        by_op[n[:160]] += s
    gaps = []
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host.sort()
    starts = [s for s, _e, _n in host]
    by_span = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        name = host[k][2] if k >= 0 and mid < host[k][1] else "other"
        by_span[name] += (b - a) * 1e-9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    traced.breakdown = {"device_ops": [[n, s] for n, s in top],
                        "idle_gaps": [[n, s] for n, s in idle]}
