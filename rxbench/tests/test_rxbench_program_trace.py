"""The profiler-free stretch (``rxbench/program_trace.py``) rehearsed on
the CPU at small cuts, after a traced run's window and slice, on every
entry: its copy of the tracer's totals is the slice's, every per-layer
metric reads from that copy what it read before the stretch (and the
program's span metrics would read more from the live totals), the
entry's wrappers are off while it runs and back after, the tracer is
off, the check still passes, and its readings are None on a CPU, where
no device interval is recorded."""

import importlib
import math

import pytest
import torch

from rxbench import core, program_spans, program_trace
from rxbench.tests.test_rxbench_multi import SIZE as BAND_SIZE
from rxbench.tests.test_rxbench_program_spans import EME_CUT
from rxbench.tests.test_rxbench_radar import SIZE as RADAR_SIZE
from rxbench.tests.test_rxbench_spur import SIZE as QRSS_SIZE
from rxbench.tests.test_rxbench_spur import every_block  # noqa: F401
from rxbench.tests.tiny import SEED, size

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
CUTS = {"ssb-nb-96k.impulsive": (size("ssb-nb-96k.impulsive"), 0.6),
        "wcw-eme-48k-xy.drift": (EME_CUT, 0.6),
        "ssb-nb-96k.fleet8": (size("ssb-nb-96k.fleet8"), 2.0),
        "radar-96k.moon": (RADAR_SIZE, 0.6),
        "ssb-multi24-2msps.band": (BAND_SIZE, 0.6),
        "qrss-96k-spur.grabber": (QRSS_SIZE, 0.4)}
ROOTS = {"receiver": "rx.block", "spur": "rx.block", "fleet": "batch.call",
         "radar": "radar.block", "multi": "multi.block"}


@pytest.fixture
def fresh_tracer():
    from linrad_tpu_torch.utils import trace
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def traced_session(cell: str):
    """A run of ``cell`` at its cut, set up, its window and its profiled
    slice done as a traced run does them."""
    cut, seconds = CUTS[cell]
    w = core.find(BENCH["workloads"], cell, "workload")
    cfg = core.find(BENCH["configs"], w["config"], "config")
    traffic = core.load_json(core.BENCH_DIR / "traffic"
                             / f"{w['traffic']}.json")
    run = core.Run(w, core.load_json(core.ROOT / cfg["file"]), traffic,
                   SEED, seconds, True, "cpu", dict(cut))
    torch.manual_seed(SEED % (1 << 63))
    entry = importlib.import_module(f"rxbench.entries.{traffic['entry']}")
    session = entry.setup(run)
    session.window(seconds, core.sample_times(
        SEED, seconds, traffic["check"]["window_samples"]))
    traced = session.trace_slice()
    return run, entry, session, traced


def metric_values(cell: str, traced) -> dict:
    return {k: v["value"] for k, v in core.read_metrics(
        BENCH["per_layer"], cell, "metrics", traced).items()}


def wrappers(session) -> list:
    """The receiver entry's wrapped callables in place (none elsewhere)."""
    if not getattr(session, "saved", None):
        return []
    from linrad_tpu_torch.pipeline import receiver as mod
    return [mod._as_block, mod._owned, vars(session.rx).get("_advance"),
            vars(session.rx.control).get("update")]


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_the_stretch_leaves_the_slice_readings(cell, fresh_tracer,
                                               every_block, monkeypatch):
    trace = fresh_tracer
    run, entry, session, traced = traced_session(cell)
    slice_totals = trace.totals()
    before = metric_values(cell, traced)
    wrapped = wrappers(session)
    seen = []

    def unwrapped() -> bool:
        if not wrapped:
            return True
        from linrad_tpu_torch.pipeline import receiver as mod
        return (mod._as_block is not wrapped[0]
                and mod._owned is not wrapped[1]
                and "_advance" not in vars(session.rx)
                and "update" not in vars(session.rx.control)
                and session.spans is None)

    def watch_one(one=session.one):
        seen.append(unwrapped())
        return one()

    session.one = watch_one
    found = program_trace.stretch(session, run)
    del session.one

    t = run.traffic
    n = t.get("trace_blocks", t.get("trace_calls"))
    assert found["totals"] == slice_totals
    assert trace.totals() != slice_totals
    assert found["report"]["blocks"] == n
    root = ROOTS[t["entry"]]
    assert found["report"]["spans"][root]["count"] == n
    assert len(seen) == program_trace.WARM_BLOCKS + n and all(seen)
    assert wrappers(session) == wrapped
    if getattr(session, "spans", None) is not None:
        assert session.spans.take() == {}
    assert trace.span("t.after") is trace._OFF and not trace.device_on()
    assert found["readings"] == dict.fromkeys(program_trace.READINGS)
    assert found["captures_inside"] == 0 and found["missed"] == 0
    assert run.lines[-1].startswith("rxbench: program trace ")

    with monkeypatch.context() as m:
        m.setattr(program_spans, "totals", lambda: found["totals"])
        assert metric_values(cell, traced) == before
    if cell.startswith("wcw"):
        live = metric_values(cell, traced)
        assert live["afc_read_ms_per_block"] != before[
            "afc_read_ms_per_block"]

    data = session.release()
    records = core.compare.judged(entry.check(run, data))
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell}.json")
    correct, checks = core.judge(core.compare.aggregate(records), limits)
    assert correct, {k: c for k, c in checks.items()
                     if not (math.isfinite(c["value"]) and c["limit"]
                             is not None and c["value"] <= c["limit"])}


def test_readings_of_a_report_with_device_intervals(fresh_tracer):
    """The seven readings of a report as the stretch takes it on a card:
    the idle sums over the root spans' count, the stages a replay."""
    trace = fresh_tracer
    spans = [("rx.h2d", "rx.block", 1, 0, 100, 1, 0),
             ("rx.replay", "rx.block", 1, 100, 200, 1, 0),
             ("spur.search", "control.spur", 1, 500, 800, 3, 0),
             ("control.spur", "control.update", 1, 490, 900, 2, 0),
             ("control.update", "rx.block", 1, 200, 950, 1, 0),
             ("rx.block", None, 1, 0, 1000, 0, 0)]
    ivs = [("rx.h2d", 1, 20, 100), ("graph.replay", 1, 150, 500),
           ("rx.owned", 1, 860, 980)]
    rep = {"blocks": 2, "device": trace._device_report(spans, ivs),
           "stage_ms": {"step.blanker": 0.18, "step.agc": 0.13,
                        "step.sellim": 0.05}}
    got = program_trace.readings(rep)
    assert got["device_idle_ms_per_block"] == pytest.approx(410e-6 / 2)
    assert got["driver_idle_ms_per_block"] == pytest.approx(50e-6 / 2)
    assert got["control_idle_ms_per_block"] == pytest.approx(360e-6 / 2)
    assert (got["blanker_stage_ms_per_block"], got["agc_stage_ms_per_block"],
            got["sellim_stage_ms_per_block"]) == (0.18, 0.13, 0.05)
    assert got["spur_stage_ms_per_block"] is None
    assert program_trace.readings({"blocks": 0, "device": {},
                                   "stage_ms": {}}) == dict.fromkeys(
        program_trace.READINGS)
