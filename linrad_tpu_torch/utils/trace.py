"""Spans and counters inside the port: where a block's time goes on the
host and, when the operator asks, on the device.

Linrad shows each thread's workload on its timing display (timing.c, the
per-thread shares of menu.c:914-957).  The port's counterpart:

- **Spans.**  ``with span("rx.h2d"):`` around a piece of the host's work.
  A span records its name, its parent span, the id of the block or call
  it serves (every span under a :func:`root` span shares the root's id),
  and its start and end on ``time.perf_counter_ns``, into a ring of the
  last :data:`RING` records.  Per-name totals (count, seconds, and self
  seconds: the span less the part its child spans cover) are kept
  besides.
- **The switch.**  A span records only while tracing is on: after
  :func:`enable` (the operator's switch), or while a ``torch.profiler``
  session records.  A root span looks at the profiler's state once per
  block; every other span checks one module-level flag, and with tracing
  off costs that check and nothing else.  While the profiler records,
  each span is also a ``record_function`` range of its name, so that the
  program's spans nest with the device's kernels on the profiler's clock.
- **Set-up spans** (:func:`setup`: ``graph.warmup``, ``graph.capture``,
  and ``graph.timed_capture``, each of a graph's stage-timed twins)
  record whether tracing is on or not; they run once per graph.
- **Counters** (:data:`counters`) are plain integers and always on:
  ``h2d_bytes`` and ``d2h_bytes``, the bytes the program hands from host
  memory to its device and reads back into host memory (counted at its
  own copies, whatever the device: on a CPU device they move nothing),
  ``structure_switches``, a receiver's replays of another tuning
  structure's graph than the one it replayed before (the AFC's lock),
  ``subrx_blocks``, the sub-receiver blocks a ``MultiReceiver``
  processed (K a block), and the spur manager's decisions
  (``weak/spur.py:SpurManager.scan``): ``spur_scans``, ``spur_adds``,
  ``spur_drops`` and ``spur_shifts`` (re-centres), and
  ``spur_full_sorts``, its scans of a wide spectrum that fell back from
  exact selection to the full median or sort.
  :func:`report` also reads the counters kept elsewhere: the controls'
  ``host_reads`` and ``spur_slots`` (active slots after the latest
  scan), the graphs' ``replays`` and the hand kernels' launches
  (``launches``: ``utils/cuda_build.COUNTS``, each kernel's launches
  outside a capture and its calls recorded into CUDA graphs; the capture
  of a graph's stage-timed twins adds to the recorded calls, as any
  capture does).
- **Device intervals** (after :func:`enable`, on a CUDA device): a
  timing-event pair around each graph replay, each block's copy in and
  the other device work a span names (``span(..., device=...)``), read
  once it has completed, never waited for, and placed on the host's clock
  through an anchor event recorded on an idle device.  An interval opens
  when the stream reaches its first event: on an idle stream that is when
  the host records it, so the enqueue of its first operation counts as
  busy.  While device intervals are on, a ``GraphedStep`` replays
  stage-timed twins of its graph in turns (``pipeline/batch.py``),
  captured at the first such replay: the same kernels with a
  timing-event pair at each stage boundary (:func:`stage`), so each
  replay gives every stage's device time (a stage entered twice in a
  step, as ``step.fft2`` is around the spur canceller's ``step.spur``,
  summed a replay), read after the next replay has been enqueued
  (:func:`after_replay`), while the device works.  The graph replayed
  with tracing off carries no extra node, whenever tracing was turned
  on.  The profiler alone turns on no event and no synchronisation: the
  program adds no device operation to a profiled run.

:func:`report` returns the totals, the device's busy time a block, its
idle share, each idle gap's time by the innermost span open at its
midpoint, the spread of device ms per replay and the stages' device ms;
:func:`idle_ms` sums a report's idle gaps, all or those under spans of
some names; :func:`write` writes the spans and device intervals as a
Chrome trace.
The tracer is the process's, as the profiler is: :func:`reset` clears it.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from . import cuda_build

RING = 1 << 16                 # span records, and device intervals, kept
REANCHOR_NS = 10 * 10 ** 9     # an anchor older than this is taken anew

_enabled = False     # the operator's switch
_on = False          # what every span checks: _enabled, or a profiler seen
_device = False      # device intervals: _enabled on a machine with CUDA

counters = {"h2d_bytes": 0, "d2h_bytes": 0, "structure_switches": 0,
            "subrx_blocks": 0, "spur_scans": 0, "spur_adds": 0,
            "spur_drops": 0, "spur_shifts": 0, "spur_full_sorts": 0}

_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
_roots: set = set()              # names opened by root()
_setups: set = set()             # names opened by setup()
_spans: deque = deque(maxlen=RING)       # see records()
_totals: dict = {}               # name -> [count, ns, self ns]
_intervals: deque = deque(maxlen=RING)   # (name, block, t0 ns, t1 ns)
_pending: deque = deque()        # (name, block, index, ev0, ev1, anchor)
_stage_reads: deque = deque()    # (graph, replays, block, anchor)
_stage_log: deque = deque(maxlen=RING)   # (host ns, {name: ms}) a replay
_anchors: dict = {}              # device index -> (event, host ns)
_free: dict = {}                 # device index -> [timing events]
_capture = None                  # a list while a GraphedStep captures
_timed = False                   # the capture records the stages' events
_watched: dict = {}              # report's name -> (attribute, objects)
_missed = [0]                    # stage readings lost to a later replay


class _Off:
    """The span with tracing off.  Entering and leaving it call a C method
    that takes any arguments and returns '' (false, so that an exception
    passes through): cheaper than any method written in Python."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class _Span:
    __slots__ = ("name", "block", "root", "dev", "t0", "child", "rf",
                 "parent", "depth", "open")

    def __init__(self, name: str, device=None, block: int | None = None,
                 root: bool = False):
        self.name = name
        self.block = block
        self.root = root
        self.dev = device if (_device and device is not None
                              and device.type == "cuda") else None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        self.depth = len(stack)
        if self.block is None:
            self.block = up.block if up is not None else 0
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.child = 0
        stack.append(self)
        self.open = _begin(self.dev) if self.dev is not None else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.open is not None:
            _end(self.name, self.block, self.open)
        stack = _stack()
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = t1 - self.t0
        if stack:
            stack[-1].child += dur
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child
            _spans.append((self.name, self.parent, self.block, self.t0, t1,
                           self.depth, threading.get_ident()))
        if self.root and _device:
            _resolve()
            _refresh_anchors()
        return False


class _Interval:
    """A device interval without a host span: a timing-event pair."""

    __slots__ = ("name", "dev", "block", "open")

    def __init__(self, name: str, device):
        self.name = name
        self.dev = device

    def __enter__(self):
        stack = _stack()
        self.block = stack[-1].block if stack else 0
        self.open = _begin(self.dev)
        return self

    def __exit__(self, *exc):
        _end(self.name, self.block, self.open)
        return False


class _StageEvents:
    """A stage of a step under a timed CUDA graph capture: a timing-event
    pair recorded into the graph (external events: each replay records
    them)."""

    __slots__ = ("name", "ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.ev0 = torch.cuda.Event(enable_timing=True, external=True)
        self.ev0.record()
        return self

    def __exit__(self, *exc):
        ev1 = torch.cuda.Event(enable_timing=True, external=True)
        ev1.record()
        _capture.append((self.name, self.ev0, ev1))
        return False


# ---- the switch -------------------------------------------------------

def enable() -> None:
    """Turn tracing on (the operator's switch): spans record, and on a
    CUDA device so do device intervals and, through the graphs'
    stage-timed twins, the stages of every graph replayed from now on."""
    global _enabled, _on, _device
    _enabled = _on = True
    _device = torch.cuda.is_available()


def disable() -> None:
    """Turn the operator's switch off (a profiler session still records
    spans)."""
    global _enabled, _device, _on
    _enabled = _device = False
    _on = bool(_profiler._is_profiler_enabled)


def device_on() -> bool:
    """Whether device intervals are recorded."""
    return _device


def reset() -> None:
    """Forget every span, total, device interval and stage reading, and
    zero the counters (the switch stays as it is)."""
    with _lock:
        for store in (_spans, _intervals, _pending, _stage_reads,
                      _stage_log):
            store.clear()
        for d in (_totals, _anchors):
            d.clear()
        _roots.clear()
        _setups.clear()
        _missed[0] = 0
        for k in counters:
            counters[k] = 0


def add(counter: str, n: int) -> None:
    """Add n to one of :data:`counters`."""
    with _lock:
        counters[counter] += n


def watch(name: str, obj, attr: str) -> None:
    """Let :func:`report` read the counter ``attr`` that ``obj`` keeps,
    summed over such objects under ``name`` (a graph's ``replays``, a
    control's ``host_reads``)."""
    _watched.setdefault(name, (attr, weakref.WeakSet()))[1].add(obj)


def next_id() -> int:
    """A new block id (a graph's set-up spans take one too)."""
    return next(_ids)


# ---- spans ------------------------------------------------------------

def span(name: str, device=None):
    """A span of the host's work; with ``device`` (a torch.device) also a
    device interval of the same name while device intervals are on."""
    if not _on:
        return _OFF
    return _open(name, device)


def _open(name: str, device=None):
    global _on
    if not (_enabled or _profiler._is_profiler_enabled):
        _on = False          # the profiler session that turned it on ended
        return _OFF
    return _Span(name, device)


def root(name: str, device=None):
    """A span that starts a block or a call: it takes a new block id, and
    it looks at the profiler's state for every span until the next root.
    Its end reads the device intervals that have completed."""
    global _on
    _on = _enabled or bool(_profiler._is_profiler_enabled)
    if not _on:
        return _OFF
    _roots.add(name)
    return _Span(name, device, next(_ids), root=True)


def setup(name: str, block: int):
    """A set-up span: it records whether tracing is on or not."""
    _setups.add(name)
    return _Span(name, None, block)


def interval(name: str, device):
    """A device interval alone (a graph's replay), while device intervals
    are on and ``device`` is a CUDA device."""
    if not _device or device.type != "cuda":
        return _OFF
    return _Interval(name, device)


def stage(name: str):
    """A stage of a step (``step.fft1``): a span when the step runs
    eagerly; under a GraphedStep's timed capture, a timing-event pair
    recorded into the graph; under its other captures and warm-ups,
    nothing."""
    if not _on:
        return _OFF
    if _capture is not None:
        return _StageEvents(name) if _timed else _OFF
    return _open(name)


@contextlib.contextmanager
def capturing(timed: bool = False):
    """Around a GraphedStep's warm-up or capture: the stages record no
    span, and with ``timed`` each records its event pair into the list
    this yields."""
    global _capture, _timed
    _capture, _timed = [], timed
    try:
        yield _capture
    finally:
        _capture, _timed = None, False


def before_replay(graph) -> None:
    """Before a replay of ``graph``, whose ``stages`` were captured: its
    last replay's stage events are read now if that has not been done
    and they have completed (the replay records the same events anew),
    and this replay's are read once they have completed (by
    :func:`after_replay`, a root span's end or a report), unless the
    graph is replayed again first."""
    _resolve_stages(graph)
    stack = _stack()
    block = stack[-1].block if stack else 0
    _stage_reads.append((graph, graph.replays + 1, block,
                         _anchor(_index(graph.device))))


def after_replay() -> None:
    """After a replay has been enqueued: read the device intervals and
    stage events that have completed, while the device works."""
    _resolve()


# ---- device events ----------------------------------------------------

def _index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _record(i: int) -> torch.cuda.Event:
    pool = _free.get(i)
    ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(i))
    return ev


def _begin(device) -> tuple:
    """The opening of a device interval: (device index, anchor, event)."""
    i = _index(device)
    anchor = _anchor(i)
    return i, anchor, _record(i)


def _end(name: str, block: int, opened: tuple) -> None:
    i, anchor, ev0 = opened
    _pending.append((name, block, i, ev0, _record(i), anchor))


def _take_anchor(i: int) -> tuple:
    """An event on the idle device and the host's clock when it ran."""
    torch.cuda.synchronize(i)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(i))
    ns = time.perf_counter_ns()
    ev.synchronize()
    _anchors[i] = (ev, ns)
    return _anchors[i]


def _anchor(i: int) -> tuple:
    a = _anchors.get(i)
    return a if a is not None else _take_anchor(i)


def _refresh_anchors() -> None:
    """Take an anchor anew where it has grown old (the clocks drift, and
    an event's ms since the anchor is a float): one synchronise every
    REANCHOR_NS while tracing is on."""
    now = time.perf_counter_ns()
    for i, (_ev, ns) in list(_anchors.items()):
        if now - ns > REANCHOR_NS:
            _take_anchor(i)


def _host_ns(anchor: tuple, ev) -> int:
    return anchor[1] + int(anchor[0].elapsed_time(ev) * 1e6)


def _resolve() -> None:
    """Read the device intervals and stage events that have completed."""
    _resolve_intervals()
    _resolve_stages()


def _resolve_intervals() -> None:
    keep = deque()
    while _pending:
        item = _pending.popleft()
        name, block, i, ev0, ev1, anchor = item
        if not ev1.query():
            keep.append(item)
            continue
        t0, t1 = _host_ns(anchor, ev0), _host_ns(anchor, ev1)
        with _lock:
            _intervals.append((name, block, t0, t1))
        _free.setdefault(i, []).extend((ev0, ev1))
    if len(keep) > RING:     # never completed: the device was lost
        keep = deque(list(keep)[-RING:])
    _pending.extend(keep)


def _resolve_stages(only=None) -> None:
    """Read the stage events that have completed: every graph's, or those
    of the graph ``only``."""
    keep = deque()
    while _stage_reads:
        item = _stage_reads.popleft()
        graph, replays, block, anchor = item
        if only is not None and graph is not only:
            keep.append(item)
            continue
        if graph.replays != replays:
            _missed[0] += 1                  # re-recorded by a later replay
            continue
        if not graph.stages[-1][2].query():
            keep.append(item)
            continue
        # every stage's ms from the first event: one read from the anchor
        first = graph.stages[0][1]
        base = _host_ns(anchor, first)
        spans = [(name, first.elapsed_time(ev0), first.elapsed_time(ev1))
                 for name, ev0, ev1 in graph.stages]
        per_replay: dict = {}
        for name, a, b in spans:
            per_replay[name] = per_replay.get(name, 0.0) + b - a
        with _lock:
            _stage_log.append((base, per_replay))
            for name, a, b in spans:
                _intervals.append((name, block, base + int(a * 1e6),
                                   base + int(b * 1e6)))
    _stage_reads.extend(keep)


# ---- reading ----------------------------------------------------------

def totals() -> dict:
    """name -> {"count", "seconds", "self_seconds"} of every span since
    the last :func:`reset`."""
    with _lock:
        return {k: {"count": c, "seconds": ns * 1e-9,
                    "self_seconds": own * 1e-9}
                for k, (c, ns, own) in _totals.items()}


def seconds(name: str, block: int | None = None) -> float:
    """Seconds spent in spans of ``name``: all of them since the last
    :func:`reset`, or those of one block id still in the ring."""
    if block is None:
        with _lock:
            return _totals.get(name, [0, 0, 0])[1] * 1e-9
    with _lock:
        return sum(t1 - t0 for n, _p, b, t0, t1, _d, _t in _spans
                   if n == name and b == block) * 1e-9


def records() -> list:
    """The ring's span records: (name, parent, block, start ns, end ns,
    depth, thread id), in the order they ended."""
    with _lock:
        return list(_spans)


def device_intervals() -> list:
    """The completed device intervals: (name, block, start ns, end ns) on
    the host's clock."""
    _resolve()
    with _lock:
        return list(_intervals)


def _merge(spans: list) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(opened: list, starts: list, t: int) -> str:
    """The innermost span open at host time t (spans nest in a thread, so
    the last to start of those still open)."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0:
        name, _p, _b, _t0, t1, _d, _th = opened[k]
        if t1 > t:
            return name
        k -= 1
    return "other"


def _spread(ms: list) -> dict:
    q = np.percentile(ms, [0, 5, 25, 50, 75, 95, 100])
    return {"count": len(ms), **{k: float(v) for k, v in zip(
        ("min", "p5", "p25", "median", "p75", "p95", "max"), q)}}


def _device_report(spans: list, ivs: list) -> dict:
    """Busy and idle of the device over the stretch that both rings
    cover, from the program's intervals (stage events lie inside their
    replay and are left out)."""
    work = [iv for iv in ivs if not iv[0].startswith("step.")]
    if not work or not spans:
        return {}
    lo = max(min(iv[2] for iv in work), min(s[3] for s in spans))
    hi = max(iv[3] for iv in work)
    work = [(n, b, max(t0, lo), t1) for n, b, t0, t1 in work if t1 > lo]
    if hi <= lo or not work:
        return {}
    busy = _merge([(t0, t1) for _n, _b, t0, t1 in work])
    busy_ns = sum(b - a for a, b in busy)
    by_block: dict = {}
    for _n, b, t0, t1 in work:
        by_block.setdefault(b, []).append((t0, t1))
    per_block = [sum(b - a for a, b in _merge(v)) for v in by_block.values()]
    opened = sorted(spans, key=lambda s: s[3])
    starts = [s[3] for s in opened]
    idle: dict = {}
    for (_a, b), (c, _d) in zip(busy, busy[1:]):
        name = _innermost(opened, starts, (b + c) // 2)
        idle[name] = idle.get(name, 0.0) + (c - b) * 1e-6
    replays = [(t1 - t0) * 1e-6 for n, _b, t0, t1 in work
               if n == "graph.replay"]
    out = {"window_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9,
           "idle_share": 1.0 - busy_ns / (hi - lo),
           "busy_ms_per_block": 1e-6 * float(np.mean(per_block)),
           "blocks": len(per_block),
           "idle_ms_by_span": dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1]))}
    if replays:
        out["replay_ms"] = _spread(replays)
    return out


def _watched_counters() -> dict:
    out = {name: sum(getattr(o, attr) for o in list(objs))
           for name, (attr, objs) in _watched.items()}
    out["launches"] = {k: [c.launches, c.captured]
                       for k, c in cuda_build.COUNTS.items()}
    return out


def _stages_since(since_ns: int | None) -> dict:
    """name -> (replays read, device ms) of the last :data:`RING` replays
    read, those whose first stage began from ``since_ns`` on."""
    out: dict = {}
    for t, per_replay in _stage_log:
        if since_ns is None or t >= since_ns:
            for name, ms in per_replay.items():
                k, total = out.get(name, (0, 0.0))
                out[name] = (k + 1, total + ms)
    return out


def report(since_ns: int | None = None) -> dict:
    """What the tracer holds: span totals, ms a block by span (over the
    root spans' count; the set-up spans left out), the counters, and,
    where device intervals were recorded, the device's busy and idle time
    and the stages' device ms a replay.  ``since_ns``: the spans,
    intervals and stage readings from that host time on (the totals
    always hold everything since the last :func:`reset`)."""
    _resolve()
    with _lock:
        spans = [s for s in _spans if since_ns is None or s[3] >= since_ns]
        ivs = [iv for iv in _intervals
               if since_ns is None or iv[2] >= since_ns]
        stage_ms = _stages_since(since_ns)
        count = dict(counters)
        roots, setups = set(_roots), set(_setups)
    tot = totals()
    if since_ns is not None:
        tot = {}
        for n, _p, _b, t0, t1, _d, _t in spans:
            t = tot.setdefault(n, {"count": 0, "seconds": 0.0})
            t["count"] += 1
            t["seconds"] += (t1 - t0) * 1e-9
    blocks = sum(t["count"] for n, t in tot.items() if n in roots)
    return {
        "spans": tot,
        "blocks": blocks,
        "ms_per_block": {n: 1e3 * t["seconds"] / blocks
                         for n, t in tot.items()
                         if n not in setups} if blocks else {},
        "counters": {**count, **_watched_counters()},
        "device": _device_report(spans, ivs),
        "stage_ms": {n: ms / k for n, (k, ms) in stage_ms.items()},
        "stage_replays": max((k for k, _ms in stage_ms.values()),
                             default=0),
        "stage_readings_missed": _missed[0],
    }


def idle_ms(dev: dict, *prefixes: str) -> float | None:
    """ms the device stood idle in a device report (``report()["device"]``):
    its window less its busy time, or, given ``prefixes``, the idle gaps
    whose innermost open span's name starts with one of them (``"control."``:
    the card waiting on the host's control).  None for an empty report."""
    if not dev:
        return None
    if not prefixes:
        return 1e3 * (dev["window_s"] - dev["busy_s"])
    return sum(ms for name, ms in dev["idle_ms_by_span"].items()
               if name.startswith(prefixes))


def timing(window_s: float = 2.0) -> dict:
    """The operator's timing display: ms a block by span, the device's
    busy share and idle ms a block by span over the last ``window_s``
    seconds, and the stages' device ms."""
    rep = report(time.perf_counter_ns() - int(window_s * 1e9))
    dev = rep["device"]
    blocks = max(dev.get("blocks", 0), 1)
    return {"ms_per_block": rep["ms_per_block"],
            "device_busy_share": (1.0 - dev["idle_share"]) if dev else None,
            "idle_ms_per_block": {n: ms / blocks for n, ms in
                                  dev.get("idle_ms_by_span", {}).items()},
            "stage_ms": rep["stage_ms"]}


def write(path) -> None:
    """The ring's spans and the device intervals as a Chrome trace (JSON,
    microseconds on the host's clock; the host's spans by thread, the
    device's intervals on lanes of their own)."""
    ivs = device_intervals()
    spans = records()
    events = []
    for name, parent, block, t0, t1, _d, thread in spans:
        events.append({"name": name, "ph": "X", "pid": "host",
                       "tid": thread, "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": {"block": block, "parent": parent}})
    for name, block, t0, t1 in ivs:
        lane = ("stages" if name.startswith("step.") else
                "replays" if name == "graph.replay" else "copies and steps")
        events.append({"name": name, "ph": "X", "pid": "device",
                       "tid": lane, "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": {"block": block}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def span_cost_ns(n: int = 200_000) -> dict:
    """ns a span costs on this host, the least of five runs of ``n``, an
    empty loop's time taken off: with tracing off (a span, a root span),
    and on (a span, recorded).  The switch is left off and the tracer
    empty."""
    def loop(make) -> float:
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with make("cost"):
                    pass
            best = min(best, time.perf_counter_ns() - t0)
        return best / n

    def empty() -> float:
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                pass
            best = min(best, time.perf_counter_ns() - t0)
        return best / n

    disable()
    base = empty()
    out = {"off_span": loop(span) - base, "off_root": loop(root) - base}
    enable()
    out["on_span"] = loop(span) - base
    disable()
    reset()
    return out


if __name__ == "__main__":
    import platform
    print(f"trace: ns a span on {platform.processor() or 'this host'} "
          f"(Python {platform.python_version()}, torch {torch.__version__}):"
          f" {span_cost_ns()}")
