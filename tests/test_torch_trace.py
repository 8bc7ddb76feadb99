"""The port's tracer (linrad_tpu_torch/utils/trace.py): spans, their
switch, set-up spans, counters, the device report's arithmetic and its
idle sums, the Chrome trace; the spans and counters of a Receiver with
the AFC on, of one with the spur canceller and of a FleetRunner, and
their outputs bit-identical with tracing on and off; the stage spans of
an eager step; the stages under a capture, and a GraphedStep's choice
between its graph and its stage-timed twin (on a stand-in graph).

The tests marked ``card`` need a CUDA device (they skip here): the
device intervals against CUDA events, the stage events of the
stage-timed twins (a receiver built with tracing on, one built with it
off and then turned on, and off again), the twins' outputs bit-identical
to the graphs' (flagship, EME across the AFC's structure switch, the
QRSS grabber with spur slots), and the flagship Receiver's outputs with
tracing on and off.  They decide so in the ``card`` fixture below.
This file imports no JAX and needs nothing of ``tests/conftest.py``
(which imports JAX), so that on the machine with the card
``python -m pytest --noconftest tests/test_torch_trace.py -m card``
runs them.
"""

import dataclasses
import json
import time
from collections import deque

import numpy as np
import pytest
import torch

from linrad_tpu_torch import RxMode, derive_geometry, flagship_params, preset
from linrad_tpu_torch.parallel import FleetRunner
from linrad_tpu_torch.pipeline import batch
from linrad_tpu_torch.pipeline.batch import GraphedStep, tensor_leaves
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.utils import trace

EME_TUNE_HZ = 1_000.0
EME_STEPS = 10
TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
            max_pulses_per_block=8)
STAGES = ["step.fft1", "step.sellim", "step.timf2", "step.blanker",
          "step.fft2", "step.mix1", "step.fft3", "step.mix2", "step.pol",
          "step.demod", "step.agc"]
FLAGSHIP_STAGES = [s for s in STAGES if s != "step.pol"]
# with the spur canceller: its subtraction between fft2's transform and
# its power spectrum
SPUR_STAGES = (FLAGSHIP_STAGES[:5] + ["step.spur", "step.fft2"]
               + FLAGSHIP_STAGES[5:])


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tracer():
    """The process's tracer, off and empty before and after."""
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def eme_params():
    """The tiny EME configuration: WCW on an X/Y pair, adaptive
    polarization, the coherent AFC."""
    return preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
                  pol_adapt_enable=True, fft1_variant="pallas", **TINY)


def eme_input(geo, steps: int, seed: int = 3) -> np.ndarray:
    """A keyed carrier 5 Hz over the dial drifting 0.05 Hz/s, split 0.8 :
    0.6j over the two channels, noise, a strong carrier and 12 impulses a
    step (tests/test_torch_graphed_receivers.py's EME input)."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 3).astype(np.float64)
    phase = 2 * np.pi * np.cumsum(EME_TUNE_HZ + 5.0 + 0.05 * t) / fs
    x = (key * np.exp(1j * phase))[:, None] * np.array([0.8, 0.6j])
    x = x + rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    x = x + (100.0 * np.exp(2j * np.pi * -15_000.0 * t + 0.3j)[:, None]
             * np.array([1.0, 0.5]))
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += (300.0 * np.exp(2j * np.pi * rng.uniform(size=(12, 1)))
                   * np.array([1.0, 0.7]))
    return x.astype(np.complex64)


def noise_blocks(geo, steps: int, seed: int = 5) -> list:
    """Flagship input: noise, a tone over the dial, impulses."""
    rng = np.random.default_rng(seed)
    s = geo.samples_per_step
    out = []
    for _ in range(steps):
        x = 10.0 * (rng.normal(size=s) + 1j * rng.normal(size=s))
        x += 30.0 * np.exp(2j * np.pi * 12_645.6 * np.arange(s)
                           / geo.timf1_sampling_speed)
        pos = rng.integers(0, s, 40)
        x[pos] += 3000.0 * np.exp(2j * np.pi * rng.uniform(size=40))
        out.append(x.astype(np.complex64)[:, None])
    return out


def block_tree(records: list, block: int) -> set:
    """(name, parent) of every span of one block."""
    return {(r[0], r[1]) for r in records if r[2] == block}


# ---- the tracer ---------------------------------------------------------

def test_spans_nest_with_self_time_and_block_ids(tracer):
    trace.enable()
    for _ in range(2):
        with trace.root("t.block"):
            with trace.span("t.outer"):
                time.sleep(0.002)
                with trace.span("t.inner"):
                    time.sleep(0.003)
            with trace.span("t.other"):
                pass
    recs = trace.records()
    roots = [r for r in recs if r[0] == "t.block"]
    assert len(roots) == 2 and roots[0][2] != roots[1][2]
    for root in roots:
        assert block_tree(recs, root[2]) == {
            ("t.block", None), ("t.outer", "t.block"),
            ("t.inner", "t.outer"), ("t.other", "t.block")}
        depth = {r[0]: r[5] for r in recs if r[2] == root[2]}
        assert depth == {"t.block": 0, "t.outer": 1, "t.inner": 2,
                         "t.other": 1}
        for r in recs:
            if r[2] == root[2]:
                assert root[3] <= r[3] <= r[4] <= root[4]
    tot = trace.totals()
    assert tot["t.inner"]["count"] == 2
    assert tot["t.inner"]["self_seconds"] == tot["t.inner"]["seconds"]
    assert tot["t.outer"]["self_seconds"] == pytest.approx(
        tot["t.outer"]["seconds"] - tot["t.inner"]["seconds"])
    assert 0.0035 <= tot["t.outer"]["self_seconds"] \
        < tot["t.outer"]["seconds"]
    assert tot["t.block"]["self_seconds"] == pytest.approx(
        tot["t.block"]["seconds"] - tot["t.outer"]["seconds"]
        - tot["t.other"]["seconds"])
    rep = trace.report()
    assert rep["blocks"] == 2
    assert rep["ms_per_block"]["t.inner"] == pytest.approx(
        1e3 * tot["t.inner"]["seconds"] / 2)


def test_the_ring_keeps_the_last_records(tracer, monkeypatch):
    monkeypatch.setattr(trace, "_spans", deque(maxlen=8))
    trace.enable()
    for i in range(20):
        with trace.root("t.block"):
            pass
    recs = trace.records()
    assert len(recs) == 8
    assert [r[2] for r in recs] == sorted(r[2] for r in recs)
    assert trace.totals()["t.block"]["count"] == 20


def test_tracing_off_records_nothing(tracer):
    cpu = torch.device("cpu")
    assert trace.span("t.a") is trace._OFF
    assert trace.root("t.a") is trace._OFF
    assert trace.stage("step.fft1") is trace._OFF
    assert trace.interval("graph.replay", cpu) is trace._OFF
    with trace.root("t.block"):
        with trace.span("t.a", cpu):
            with trace.stage("step.fft1"):
                pass
    assert trace.records() == [] and trace.totals() == {}
    with pytest.raises(ValueError, match="passes"):
        with trace.span("t.a"):
            raise ValueError("passes")
    trace.add("h2d_bytes", 5)         # the counters are always on
    assert trace.counters["h2d_bytes"] == 5
    trace.enable()
    trace.disable()
    with trace.root("t.block"):
        pass
    assert trace.totals() == {}


def test_set_up_spans_record_with_tracing_off(tracer):
    graph_id = trace.next_id()
    with trace.setup("graph.capture", graph_id):
        time.sleep(0.002)
    assert trace.seconds("graph.capture", graph_id) >= 0.002
    assert trace.seconds("graph.capture", graph_id + 1) == 0.0
    assert trace.seconds("graph.capture") == trace.totals()[
        "graph.capture"]["seconds"]


def test_a_profiler_session_turns_the_spans_on_as_ranges(tracer):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.root("t.block"):
            with trace.span("t.child"):
                torch.ones(16).add_(1)
    assert {"t.block", "t.child"} <= set(trace.totals())
    events = {e.name: e for e in prof.events()}
    assert {"t.block", "t.child"} <= set(events)
    child, root = events["t.child"], events["t.block"]
    assert child.cpu_parent is not None and child.cpu_parent.name == "t.block"
    assert root.time_range.start <= child.time_range.start
    assert child.time_range.end <= root.time_range.end
    # the session has ended: the next root turns tracing off
    with trace.root("t.after"):
        with trace.span("t.after.child"):
            pass
    assert "t.after" not in trace.totals()
    assert "t.after.child" not in trace.totals()


def test_device_report_arithmetic(tracer):
    """Busy, idle share, idle by the innermost span open at a gap's
    midpoint, busy a block and the replays' spread, on intervals set by
    hand (host nanoseconds)."""
    spans = [("rx.h2d", "rx.block", 1, 0, 100, 1, 0),
             ("rx.replay", "rx.block", 1, 100, 300, 1, 0),
             ("control.read", "control.update", 1, 300, 400, 2, 0),
             ("control.update", "rx.block", 1, 300, 1000, 1, 0),
             ("rx.block", None, 1, 0, 1000, 0, 0),
             ("rx.h2d", "rx.block", 2, 1000, 1100, 1, 0),
             ("rx.replay", "rx.block", 2, 1100, 1300, 1, 0),
             ("control.update", "rx.block", 2, 1300, 2000, 1, 0),
             ("rx.block", None, 2, 1000, 2000, 0, 0)]
    ivs = [("rx.h2d", 1, 20, 80), ("graph.replay", 1, 150, 650),
           ("step.fft1", 1, 150, 300), ("rx.h2d", 2, 1020, 1080),
           ("graph.replay", 2, 1150, 1550)]
    dev = trace._device_report(spans, ivs)
    assert dev["window_s"] == pytest.approx(1530e-9)
    assert dev["busy_s"] == pytest.approx(1020e-9)
    assert dev["idle_share"] == pytest.approx(1 - 1020 / 1530)
    assert dev["busy_ms_per_block"] == pytest.approx((560 + 460) / 2 * 1e-6)
    assert dev["blocks"] == 2
    assert dev["idle_ms_by_span"] == pytest.approx(
        {"control.update": 370e-6, "rx.replay": 140e-6})
    assert dev["replay_ms"]["count"] == 2
    assert dev["replay_ms"]["median"] == pytest.approx(450e-6)
    assert dev["replay_ms"]["max"] == pytest.approx(500e-6)


def test_idle_sums_by_the_innermost_span(tracer):
    """The idle sums over a device report: all of it (the window less the
    busy union), the driver's (gaps under ``rx.*`` or ``multi.*``) and the
    control's (under ``control.*`` or ``spur.*``), on spans and intervals
    set by hand (host nanoseconds); a gap under no span counts only in
    the whole, and ``control.wait``, the host waiting on the card, leaves
    no gap here."""
    spans = [("rx.h2d", "rx.block", 1, 0, 100, 1, 0),
             ("rx.replay", "rx.block", 1, 100, 200, 1, 0),
             ("control.wait", "control.update", 1, 200, 500, 2, 0),
             ("spur.search", "control.spur", 1, 500, 800, 3, 0),
             ("control.spur", "control.update", 1, 490, 900, 2, 0),
             ("control.update", "rx.block", 1, 200, 950, 1, 0),
             ("rx.block", None, 1, 0, 1000, 0, 0),
             ("multi.h2d", "multi.block", 2, 1100, 1200, 1, 0),
             ("multi.block", None, 2, 1100, 1500, 0, 0)]
    ivs = [("rx.h2d", 1, 20, 100), ("graph.replay", 1, 150, 500),
           ("step.fft1", 1, 150, 300), ("rx.owned", 1, 860, 980),
           ("multi.h2d", 2, 1180, 1400)]
    dev = trace._device_report(spans, ivs)
    assert dev["idle_ms_by_span"] == pytest.approx(
        {"rx.replay": 50e-6, "spur.search": 360e-6, "other": 200e-6})
    whole = trace.idle_ms(dev)
    assert whole == pytest.approx((1380 - 770) * 1e-6)
    assert whole == pytest.approx(sum(dev["idle_ms_by_span"].values()))
    driver = trace.idle_ms(dev, "rx.", "multi.")
    control = trace.idle_ms(dev, "control.", "spur.")
    assert driver == pytest.approx(50e-6)
    assert control == pytest.approx(360e-6)
    assert driver + control <= whole
    assert trace.idle_ms(dev, "radar.") == 0.0
    assert trace.idle_ms({}) is None
    assert trace.idle_ms({}, "rx.") is None


def test_stage_readings_since_a_time(tracer):
    """``report(since_ns)`` averages the stages of the replays read from
    that time on; without it, every replay since the last reset."""
    trace._stage_log.extend([(100, {"step.a": 1.0}),
                             (200, {"step.a": 3.0, "step.b": 2.0}),
                             (300, {"step.a": 5.0, "step.b": 4.0})])
    rep = trace.report(since_ns=150)
    assert rep["stage_ms"] == pytest.approx({"step.a": 4.0, "step.b": 3.0})
    assert rep["stage_replays"] == 2
    assert trace.report(since_ns=301)["stage_ms"] == {}
    whole = trace.report()
    assert whole["stage_ms"] == pytest.approx({"step.a": 3.0,
                                               "step.b": 3.0})
    assert whole["stage_replays"] == 3
    trace.reset()
    assert not trace._stage_log and trace.report()["stage_ms"] == {}


def test_stages_under_a_capture(tracer):
    """A stage under a graph's capture or warm-up is the no-op span with
    tracing on or off; under a timed capture, with tracing on, an event
    pair that goes into the capture's list (entered only on a card)."""
    for on in (False, True):
        if on:
            trace.enable()
        with trace.capturing() as stages:
            assert trace.stage("step.fft1") is trace._OFF
        assert stages == []
    with trace.capturing(timed=True):
        assert isinstance(trace.stage("step.fft1"), trace._StageEvents)
    assert isinstance(trace.stage("step.fft1"), trace._Span)
    trace.disable()
    with trace.capturing(timed=True):
        assert trace.stage("step.fft1") is trace._OFF


@dataclasses.dataclass
class _Toy:
    x: torch.Tensor


def toy_step(tables, state, block):
    """A two-stage step on a toy state: x + sum(block), then twice it."""
    with trace.stage("step.a"):
        x = state.x + block.sum()
    with trace.stage("step.b"):
        y = 2.0 * x
    return _Toy(x=x), y


def toy_blocks(n: int) -> list:
    return [torch.arange(4, dtype=torch.float32) + i for i in range(n)]


def test_cpu_graphed_step_with_tracing_on(tracer):
    """On a CPU device tracing changes nothing of a GraphedStep: no graph
    and no twin, the body run eagerly with each stage a span of its
    caller, the outputs and state those of tracing off."""
    def run(on: bool):
        g = GraphedStep(toy_step, None, _Toy(x=torch.zeros(())), (4,),
                        torch.float32)
        if on:
            trace.enable()
        outs = []
        with trace.root("t.block"):
            for b in toy_blocks(3):
                outs.append(g(b).clone())
        trace.disable()
        return g, outs

    g_off, off = run(False)
    g_on, on = run(True)
    assert g_on.graph is None and g_on.timed_stages is None
    assert g_on.replays == g_off.replays == 3
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert torch.equal(g_off.state.x, g_on.state.x)
    assert torch.equal(g_on.outputs, on[-1])
    tot = trace.totals()
    assert tot["step.a"]["count"] == tot["step.b"]["count"] == 3
    assert {r[1] for r in trace.records() if r[0].startswith("step.")} \
        == {"t.block"}
    assert "graph.timed_capture" not in tot
    rep = trace.report()
    assert rep["stage_ms"] == {} and rep["device"] == {}


class _StandIn:
    """A stand-in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_or_twins_by_the_switch(tracer, monkeypatch):
    """A GraphedStep with a graph (a stand-in here) replays it while
    device intervals are off, with no stage read; while they are on it
    captures its two twins at the first call, once, and replays them in
    turns, each replay's stages asked for before it and the completed
    readings taken after it, its outputs the twin's; off again, the
    graph and its outputs; on again, the same twins.  A step without
    stages keeps none and replays its graph."""
    g = GraphedStep(toy_step, None, _Toy(x=torch.zeros(())), (4,),
                    torch.float32)
    main, main_outs = _StandIn(), torch.zeros(1)
    g.graph, g._graph_outs = main, main_outs
    made, calls = [], []

    def capture_twin():
        made.append(batch._TimedTwin(_StandIn(), [("step.a", None, None)],
                                     torch.full((1,), len(made) + 1.0),
                                     g.device))
        return made[-1]

    monkeypatch.setattr(g, "_capture_twin", capture_twin)
    monkeypatch.setattr(trace, "before_replay",
                        lambda twin: calls.append(("before", twin)))
    monkeypatch.setattr(trace, "after_replay",
                        lambda: calls.append(("after", None)))
    switch = [False]
    monkeypatch.setattr(trace, "device_on", lambda: switch[0])
    blocks = toy_blocks(9)

    assert g(blocks[0]) is main_outs and g.outputs is main_outs
    assert (main.replays, made, calls) == (1, [], [])
    assert g.timed_stages is None
    switch[0] = True
    got = [g(b) for b in blocks[1:4]]
    assert len(made) == 2
    t0, t1 = made
    assert got == [t0.outs, t1.outs, t0.outs] and g.outputs is t0.outs
    assert torch.equal(g.block, blocks[3])
    assert (main.replays, t0.graph.replays, t1.graph.replays) == (1, 2, 1)
    assert (t0.replays, t1.replays) == (2, 1)
    assert calls == [("before", t0), ("after", None), ("before", t1),
                     ("after", None), ("before", t0), ("after", None)]
    assert g.timed_stages == ["step.a"]
    switch[0] = False
    for b in blocks[4:6]:
        assert g(b) is main_outs
    assert (main.replays, len(calls)) == (3, 6)
    switch[0] = True
    assert g(blocks[6]) is t1.outs
    assert (len(made), t1.replays, g.replays) == (2, 2, 7)
    assert g.kernels == 0

    # a step that records no stage: no twin, its graph replayed
    g._twins = None
    monkeypatch.setattr(g, "_capture_twin", lambda: False)
    assert g(blocks[7]) is main_outs and g(blocks[8]) is main_outs
    assert g.timed_stages == [] and main.replays == 5
    assert len(calls) == 8


def test_chrome_trace(tracer, tmp_path):
    trace.enable()
    with trace.root("t.block"):
        with trace.span("t.child"):
            time.sleep(0.001)
    path = tmp_path / "trace.json"
    trace.write(path)
    events = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"]}
    root, child = events["t.block"], events["t.child"]
    assert root["ph"] == child["ph"] == "X"
    assert child["args"]["parent"] == "t.block"
    assert root["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= root["ts"] + root["dur"] + 1e-3


# ---- the port's spans and counters ----------------------------------------

@pytest.mark.parametrize("graphed", [True, False])
def test_receiver_spans_and_counters(tracer, graphed):
    """Each block of the tiny EME receiver (AFC on): its span tree and the
    bytes it counts; the graphed one switches structure once, at the
    AFC's lock."""
    rx = Receiver(eme_params(), device="cpu", graphed=graphed)
    rx.tune(EME_TUNE_HZ)
    geo = rx.geo
    s = geo.samples_per_step
    iq = eme_input(geo, EME_STEPS)
    trace.enable()
    statuses, outs = [], []
    for i in range(EME_STEPS):
        outs.append(rx.process_block(iq[i * s:(i + 1) * s]))
        statuses.append(rx.afc.status)
    recs = trace.records()
    roots = [r for r in recs if r[0] == "rx.block"]
    assert len(roots) == EME_STEPS
    step = "rx.replay" if graphed else "rx.step"
    for status, root in zip(statuses, roots):
        want = {("rx.block", None), ("rx.h2d", "rx.block"),
                (step, "rx.block"), ("control.update", "rx.block"),
                ("control.read", "control.update"),
                ("control.afc", "control.update")}
        want |= {(name, step) for name in STAGES}
        if graphed:
            want.add(("rx.owned", "rx.block"))
        if status in (2, 3, 4):
            want.add(("control.tune", "control.update"))
        assert block_tree(recs, root[2]) == want
    tuned = sum(st in (2, 3, 4) for st in statuses)
    assert tuned > 0
    n = geo.fftx_frames_per_step
    spec = outs[0].fft2_power
    assert trace.counters["h2d_bytes"] == (
        EME_STEPS * s * geo.channels * 8 + tuned * n * (8 + 4 + 4))
    assert trace.counters["d2h_bytes"] == EME_STEPS * spec.numel() * 4
    assert trace.counters["structure_switches"] == (1 if graphed else 0)
    rep = trace.report()
    assert rx.control.host_reads == EME_STEPS
    assert rep["counters"]["host_reads"] >= EME_STEPS
    assert rep["blocks"] == EME_STEPS
    assert rep["device"] == {}                      # no device intervals


def test_fleet_spans_and_counters(tracer):
    """A FleetRunner at R = 2, K = 2 over two calls: each call's span
    tree on the CPU path, and the bytes in and out."""
    p = flagship_params(tiny=True)
    fl = FleetRunner(p, 2, k_steps=2, outputs=("audio", "blanker_fitted"),
                     device="cpu")
    fl.tune([12_000.0, 15_000.0])
    s = fl.geo.samples_per_step
    iq = np.stack([np.concatenate(noise_blocks(fl.geo, 4, seed=j))[:, 0]
                   for j in range(2)])
    trace.enable()
    got = fl.process(iq)
    recs = trace.records()
    calls = [r for r in recs if r[0] == "batch.call"]
    assert len(calls) == 2
    for c in calls:
        assert block_tree(recs, c[2]) == {
            ("batch.call", None), ("batch.stage", "batch.call"),
            ("batch.enqueue", "batch.call"), ("batch.collect", "batch.call"),
            *((name, "batch.enqueue") for name in FLAGSHIP_STAGES)}
    assert trace.totals()["step.fft1"]["count"] == 2 * 2   # K a call
    assert trace.counters["h2d_bytes"] == 2 * 2 * 2 * s * 8
    assert trace.counters["d2h_bytes"] == sum(v.nbytes for v in got.values())


def test_outputs_bit_identical_with_tracing_on_and_off(tracer):
    def receiver_run():
        rx = Receiver(eme_params(), device="cpu", graphed=True)
        rx.tune(EME_TUNE_HZ)
        s = rx.geo.samples_per_step
        iq = eme_input(rx.geo, EME_STEPS)
        return [rx.process_block(iq[i * s:(i + 1) * s])
                for i in range(EME_STEPS)]

    def fleet_run():
        p = flagship_params(tiny=True)
        fl = FleetRunner(p, 2, k_steps=2,
                         outputs=("audio", "baseb", "blanker_fitted"),
                         device="cpu")
        fl.tune([12_000.0, 15_000.0])
        iq = np.stack([np.concatenate(noise_blocks(fl.geo, 4, seed=j))[:, 0]
                       for j in range(2)])
        return fl.process(iq)

    off = receiver_run(), fleet_run()
    trace.enable()
    on = receiver_run(), fleet_run()
    assert trace.totals()["rx.block"]["count"] == EME_STEPS
    for a, b in zip(off[0], on[0]):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert torch.equal(x, y), f.name
    for f in off[1]:
        assert np.array_equal(off[1][f], on[1][f]), f


def test_stage_spans_in_an_eager_step(tracer):
    """The eager step's stages in chain order, each a span of the step's
    caller, with no span of its own inside."""
    rx = Receiver(flagship_params(tiny=True), device="cpu", graphed=False)
    block = torch.from_numpy(noise_blocks(rx.geo, 1)[0])
    trace.enable()
    with trace.root("t.step"):
        rx._step(rx.tables, rx.state, block, rx._tune_bin)
    recs = sorted(trace.records(), key=lambda r: r[3])
    assert [r[0] for r in recs if r[1] == "t.step"] == FLAGSHIP_STAGES
    tot = trace.totals()
    for name in FLAGSHIP_STAGES:
        assert tot[name]["count"] == 1
        assert tot[name]["self_seconds"] == tot[name]["seconds"] > 0


def spur_receiver(graphed: bool) -> Receiver:
    """The tiny flagship with the spur canceller, its manager scanning
    every block (at this step size the interval would be 131 blocks)."""
    p = dataclasses.replace(flagship_params(tiny=True), spur_enable=True)
    rx = Receiver(p, device="cpu", graphed=graphed)
    rx.control.spur_scan_interval = 1
    return rx


def spur_blocks(geo) -> list:
    """The flagship input of 4 steps with a steady carrier, a birdie the
    spur canceller takes."""
    s = geo.samples_per_step
    t = np.arange(4 * s) / geo.timf1_sampling_speed
    carrier = (100.0 * np.exp(2j * np.pi * -20_100.0 * t)).astype(
        np.complex64)[:, None]
    return [b + carrier[i * s:(i + 1) * s]
            for i, b in enumerate(noise_blocks(geo, 4))]


@pytest.mark.parametrize("graphed", [True, False])
def test_spur_spans_and_counters(tracer, graphed):
    """Each block of the tiny spur receiver: the scan's spans under
    ``control.spur`` (``spur.read`` twice: the spectrum and the tuned bin,
    then the four state tensors; ``spur.search``; ``spur.write``), the
    stages with ``step.spur`` (eagerly), and the counters of the manager's
    decisions, read from its own arrays."""
    rx = spur_receiver(graphed)
    blocks = spur_blocks(rx.geo)
    trace.enable()
    for b in blocks:
        rx.process_block(b)
    recs = trace.records()
    roots = [r for r in recs if r[0] == "rx.block"]
    assert len(roots) == len(blocks)
    step = "rx.replay" if graphed else "rx.step"
    for root in roots:
        tree = block_tree(recs, root[2])
        assert {("control.spur", "control.update"),
                ("spur.read", "control.spur"),
                ("spur.search", "control.spur"),
                ("spur.write", "control.spur")} <= tree
        mine = sorted((r for r in recs if r[2] == root[2]),
                      key=lambda r: r[3])
        assert [r[0] for r in mine if r[0].startswith("spur.")] == [
            "spur.read", "spur.read", "spur.search", "spur.write"]
        assert [r[0] for r in mine if r[1] == step] == SPUR_STAGES
    tot = trace.totals()
    assert tot["spur.search"]["count"] == len(blocks)
    assert tot["step.spur"]["count"] == len(blocks)
    assert tot["step.fft2"]["count"] == 2 * len(blocks)
    c = trace.report()["counters"]
    held = int((rx.state.spur.bins >= 0).sum())
    assert rx.control.spur_slots == held > 0
    assert c["spur_slots"] >= held
    assert c["spur_scans"] == len(blocks)
    assert c["spur_adds"] - c["spur_drops"] == held
    assert rx.control.host_reads == 6 * len(blocks)


def test_spur_outputs_bit_identical_with_tracing_on_and_off(tracer):
    def run():
        rx = spur_receiver(True)
        outs = [rx.process_block(b) for b in spur_blocks(rx.geo)]
        return outs, rx.state.spur

    off = run()
    trace.enable()
    on = run()
    assert trace.counters["spur_scans"] == 8
    for a, b in zip(off[0], on[0]):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert torch.equal(x, y), f.name
    for f in dataclasses.fields(off[1]):
        assert torch.equal(getattr(off[1], f.name), getattr(on[1], f.name))


# ---- on the card ----------------------------------------------------------

def _closed_loop(rx, blocks: list) -> list:
    """Each block through the receiver, its audio fetched to the host."""
    outs = []
    for b in blocks:
        out = rx.process_block(b)
        out.audio.cpu()
        outs.append(out)
    return outs


@pytest.mark.card
def test_card_device_intervals_against_cuda_events(tracer, card):
    """Each replay's device interval lies on the host's clock within its
    rx.replay span's reach and takes as long as CUDA events around a
    replay alone (of the stage-timed twins, which a replay with tracing
    on runs); the device report reads an idle share in (0, 1) and the
    stages."""
    rx = Receiver(flagship_params(), device=card)
    assert all(g.timed_stages is None for g in rx.graphs.values())
    blocks = noise_blocks(rx.geo, 40)
    trace.enable()
    _closed_loop(rx, blocks[:5])
    g = rx.graphs["bin"]
    assert g.timed_stages == FLAGSHIP_STAGES
    trace.disable()
    alone = []
    for k in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        g._twins[k % 2].graph.replay()
        b.record()
        torch.cuda.synchronize()
        alone.append(a.elapsed_time(b))
    trace.reset()
    trace.enable()
    outer0 = torch.cuda.Event(enable_timing=True)
    outer1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    outer0.record()
    _closed_loop(rx, blocks)
    outer1.record()
    torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    replays = [iv for iv in trace.device_intervals()
               if iv[0] == "graph.replay"]
    assert len(replays) == len(blocks)
    ms = [(e - s) * 1e-6 for _n, _b, s, e in replays]
    assert np.median(ms) == pytest.approx(np.median(alone), rel=0.1)
    spans = {r[2]: r for r in trace.records() if r[0] == "rx.replay"}
    for _n, block, s, e in replays:
        span = spans[block]
        assert span[3] - 100_000 <= s <= span[4] + 100_000
        assert t0 <= s < e <= t1 + 100_000
    window = replays[-1][3] - replays[0][2]
    assert window * 1e-6 <= outer0.elapsed_time(outer1) * 1.05
    rep = trace.report()
    assert 0.0 < rep["device"]["idle_share"] < 1.0
    assert rep["device"]["replay_ms"]["count"] == len(blocks)
    assert rep["device"]["busy_ms_per_block"] >= np.median(ms) * 0.99
    assert set(rep["stage_ms"]) == set(FLAGSHIP_STAGES)


@pytest.mark.card
def test_card_stage_events_in_a_graph_captured_with_tracing_on(tracer,
                                                               card):
    """A receiver built with tracing on: its graph carries no timing
    event, and its first replay captures the two stage-timed twins,
    which time each stage on the device at every replay of the closed
    loop; the stages fill most of a replay."""
    trace.enable()
    rx = Receiver(flagship_params(), device=card)
    g = rx.graphs["bin"]
    assert g.timed_stages is None
    assert "graph.timed_capture" not in trace.totals()
    blocks = noise_blocks(rx.geo, 30)
    _closed_loop(rx, blocks)
    torch.cuda.synchronize()
    assert g.timed_stages == FLAGSHIP_STAGES
    assert trace.totals()["graph.timed_capture"]["count"] == 2
    rep = trace.report()
    assert rep["stage_replays"] == len(blocks)
    assert rep["stage_readings_missed"] == 0
    assert set(rep["stage_ms"]) == set(FLAGSHIP_STAGES)
    replay = rep["device"]["replay_ms"]["median"]
    staged = sum(rep["stage_ms"].values())
    assert 0.7 * replay <= staged <= replay


@pytest.mark.card
def test_card_stage_times_after_enable_on_a_receiver_built_off(tracer,
                                                               card):
    """A receiver built and run with tracing off, then turned on: every
    stage's device ms from the next replay on, each at most a replay's;
    each twin's capture one set-up span."""
    rx = Receiver(flagship_params(), device=card)
    blocks = noise_blocks(rx.geo, 25)
    _closed_loop(rx, blocks[:5])
    assert trace.report()["stage_ms"] == {}
    trace.enable()
    since = time.perf_counter_ns()
    _closed_loop(rx, blocks[5:])
    torch.cuda.synchronize()
    rep = trace.report(since_ns=since)
    assert rep["stage_replays"] == 20
    assert rep["stage_readings_missed"] == 0
    assert set(rep["stage_ms"]) == set(FLAGSHIP_STAGES)
    replay = rep["device"]["replay_ms"]["median"]
    for name, ms in rep["stage_ms"].items():
        assert 0.0 < ms <= replay, name
    assert trace.totals()["graph.timed_capture"]["count"] == 2
    assert "graph.timed_capture" not in rep["ms_per_block"]


@pytest.mark.card
def test_card_no_stage_reads_after_disable(tracer, card, monkeypatch):
    """After disable() the receiver replays its graph: no stage read, no
    event, no growth in ``stage_replays``; on again, the same twins."""
    rx = Receiver(flagship_params(), device=card)
    g = rx.graphs["bin"]
    blocks = noise_blocks(rx.geo, 30)
    trace.enable()
    _closed_loop(rx, blocks[:10])
    torch.cuda.synchronize()
    twins = g._twins
    assert trace.report()["stage_replays"] == 10
    assert [t.replays for t in twins] == [5, 5]
    trace.disable()
    with monkeypatch.context() as m:
        def refused(*args):
            raise AssertionError("a stage read or an event with tracing "
                                 "off")
        m.setattr(trace, "before_replay", refused)
        m.setattr(trace, "_record", refused)
        _closed_loop(rx, blocks[10:20])
    torch.cuda.synchronize()
    assert trace.report()["stage_replays"] == 10
    assert not trace._stage_reads
    assert [t.replays for t in twins] == [5, 5] and g.replays == 20
    trace.enable()
    _closed_loop(rx, blocks[20:])
    torch.cuda.synchronize()
    assert g._twins is twins and [t.replays for t in twins] == [10, 10]
    assert trace.totals()["graph.timed_capture"]["count"] == 2
    assert trace.report()["stage_replays"] == 20


def qrss_params():
    """The QRSS grabber: 96 kHz, fft1 16,384, fft2 131,072, 524,288
    samples a step, the coherent AFC and the spur canceller."""
    return preset(RxMode.QRSS, rx_ad_speed=96_000, spur_enable=True)


def qrss_blocks(device, geo, steps: int) -> list:
    """The QRSS cell's traffic (``rxbench/generators/qrss_band.py``):
    beacons and steady birdies over noise, whose scans add spur slots."""
    from rxbench import core
    from rxbench.generators import qrss_band
    spec = {**core.load_json(core.BENCH_DIR / "traffic" / "grabber.json")[
        "ring"], "steps": steps}
    gen = torch.Generator(device=device).manual_seed(27)
    x = qrss_band.make_ring(geo, spec, gen, 1_000.0)
    s = geo.samples_per_step
    return [x[i * s:(i + 1) * s] for i in range(steps)]


def twin_case(name: str, device):
    """(params, dial or None, blocks) of one case of the twin test."""
    if name == "flagship":
        p = flagship_params()
        return p, None, noise_blocks(derive_geometry(p), 12)
    if name == "eme":
        p = preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
                   pol_adapt_enable=True, fft1_variant="pallas")
        geo = derive_geometry(p)
        s = geo.samples_per_step
        iq = eme_input(geo, 16)
        return p, EME_TUNE_HZ, [iq[i * s:(i + 1) * s] for i in range(16)]
    p = qrss_params()
    return p, 1_000.0, qrss_blocks(device, derive_geometry(p), 12)


def twin_run(p, dial, blocks, device, traced: bool):
    """The blocks through a receiver built with tracing off; with
    ``traced`` the tracer is on for the run.  Each block's outputs, AFC
    status, tuning and spur slots, and the receiver."""
    trace.disable()
    rx = Receiver(p, device=device)
    if dial is not None:
        rx.tune(dial)
    if traced:
        trace.enable()
    steps = []
    for b in blocks:
        out = rx.process_block(b)
        spur = rx.state.spur
        steps.append((
            {f.name: getattr(out, f.name) for f in dataclasses.fields(out)},
            None if rx.afc is None else rx.afc.status,
            [None if t is None else t.clone()
             for t in (rx._tune_bin, rx._tune_frac, rx._tune_slope)],
            None if spur is None else (
                [t.clone() for t in tensor_leaves(spur)],
                dict(rx.control.spur_manager._age))))
    torch.cuda.synchronize()
    trace.disable()
    return steps, rx


def same(x, y) -> bool:
    if x is None or y is None:
        return x is y
    return torch.equal(x, y)


@pytest.mark.card
@pytest.mark.parametrize("case", ["flagship", "eme", "qrss"])
def test_card_twin_bit_identical_to_the_graph(tracer, card, case):
    """The stage-timed twins against the graphs, block after block over
    12-16 blocks: every output field, the AFC's status and tuning, the
    spur slots and the final state equal bit for bit; EME and the QRSS
    grabber switch from the bin structure to the coherent AFC's, each
    with twins of its own; the grabber's scans hold spur slots."""
    p, dial, blocks = twin_case(case, card)
    graphs, rx_g = twin_run(p, dial, blocks, card, traced=False)
    switches = trace.counters["structure_switches"]
    twins, rx_t = twin_run(p, dial, blocks, card, traced=True)
    assert trace.counters["structure_switches"] == 2 * switches
    assert all(g.timed_stages is None for g in rx_g.graphs.values())
    timed = [g for g in rx_t.graphs.values() if g.timed_stages]
    assert len(timed) == (1 if case == "flagship" else 2)
    assert (switches >= 1) == (case != "flagship")
    if case == "qrss":
        assert all("step.spur" in g.timed_stages for g in timed)
        assert int((graphs[-1][3][0][0] >= 0).sum()) > 0
    for k, (a, b) in enumerate(zip(graphs, twins)):
        for name, x in a[0].items():
            assert same(x, b[0][name]), (name, k)
        assert a[1] == b[1], k
        assert all(same(x, y) for x, y in zip(a[2], b[2])), k
        if a[3] is not None:
            assert all(torch.equal(x, y) for x, y in zip(a[3][0], b[3][0]))
            assert a[3][1] == b[3][1], k
    for x, y in zip(tensor_leaves(rx_g.state), tensor_leaves(rx_t.state)):
        assert torch.equal(x, y)


@pytest.mark.card
def test_card_outputs_bit_identical_with_tracing_on_and_off(tracer, card):
    """The flagship Receiver captured and run with tracing off, and again
    built and run with tracing on (the stage-timed twin replayed, device
    intervals around its work): every output field of every block equal
    bit for bit."""
    blocks = noise_blocks(Receiver(flagship_params(), device=card).geo, 12)
    off = _closed_loop(Receiver(flagship_params(), device=card), blocks)
    trace.enable()
    rx = Receiver(flagship_params(), device=card)
    on = _closed_loop(rx, blocks)
    assert rx.graphs["bin"].timed_stages == FLAGSHIP_STAGES
    for a, b in zip(off, on):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert torch.equal(x, y), f.name
