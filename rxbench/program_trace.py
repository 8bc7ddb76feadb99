"""The port's own tracer (``linrad_tpu_torch/utils/trace.py``) read over a
stretch of blocks without the profiler, after a traced run's slice:

    python3 rxbench/program_trace.py --workload <cell> --seed <n> \
        [--seconds 2]

sets the cell up as a traced run does (the entry's wrappers on), runs its
window and its profiled slice, then :func:`stretch`, and prints the
stretch's note line and its readings (:data:`READINGS`, ms), the stages'
device ms, the spread of a replay's and ms a block by span as JSON.  No
check runs: the benchmark's own runs judge the
outputs.  The benchmark's runs do not call this module yet.

:func:`stretch` is the part of a traced run that reads the program's own
spans and device intervals: with ``trace.enable()`` each graph replays
its stage-timed twin (captured in the warm blocks), so the stretch gives
every stage's device time, and the device's idle gaps are named by the
innermost span of the program open across them, with no per-node CUPTI
trace slowing the host.  It leaves the slice's readings alone: it keeps a
copy of the tracer's span totals as the slice left them, for the
readings of the slice (``program_spans.totals``), and the entry's own
wrappers are off while it runs and back after it.  On a port without the
twins or the idle sums, and on a CPU, the readings it cannot make are
None.
"""

import os

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WARM_BLOCKS = 3     # before the measured part: the twins are captured here

# reading -> the idle sum's span-name prefixes (None: all of the idle), or
# the stage whose device ms a replay it reads
IDLE = {"device_idle_ms_per_block": None,
        "driver_idle_ms_per_block": ("rx.", "multi."),
        "control_idle_ms_per_block": ("control.", "spur.")}
STAGES = {"blanker_stage_ms_per_block": "step.blanker",
          "agc_stage_ms_per_block": "step.agc",
          "sellim_stage_ms_per_block": "step.sellim",
          "spur_stage_ms_per_block": "step.spur"}
READINGS = (*IDLE, *STAGES)


@contextlib.contextmanager
def _unwrapped(session):
    """The receiver entry's wrappers off (``Session._wrap``: the module's
    ``_as_block`` and ``_owned``, kept in ``saved``, and the receiver's
    ``_advance`` and its control's ``update``, instance attributes over
    their class's methods; the control's with a synchronise first), no
    profiler range around the fetch; the same wrappers back after."""
    saved = getattr(session, "saved", None)
    if not saved:
        yield
        return
    from linrad_tpu_torch.pipeline import receiver as mod
    wrapped = {name: getattr(mod, name) for name in saved}
    shadows = [(obj, name, vars(obj).pop(name))
               for obj, name in ((session.rx, "_advance"),
                                 (session.rx.control, "update"))
               if name in vars(obj)]
    originals, spans = dict(saved), session.spans
    session._unwrap()
    session.spans = None
    try:
        yield
    finally:
        for name, fn in wrapped.items():
            setattr(mod, name, fn)
        for obj, name, fn in shadows:
            setattr(obj, name, fn)
        session.saved, session.spans = originals, spans


def _blocks(session, run, n: int) -> None:
    one = session.one
    for _ in range(n):
        one()
    run.sync()


def stretch(session, run) -> dict:
    """The profiler-free stretch on a set-up ``session`` of ``run`` (a
    ``core.Run``), after its window and slice: the tracer's totals copied,
    the entry's wrappers off, ``trace.enable()``, :data:`WARM_BLOCKS`
    blocks, the traffic's ``trace_blocks`` (``trace_calls``) blocks, the
    report over those, ``trace.disable()``, the wrappers back.  Returns
    the report, the copy (``totals``), the blocks, the seconds and the
    readings, and notes one line on ``run``."""
    from linrad_tpu_torch.utils import trace
    t = run.traffic
    n = t.get("trace_blocks", t.get("trace_calls"))
    totals = trace.totals()
    missed0 = trace.report()["stage_readings_missed"]
    t0 = time.perf_counter()
    with _unwrapped(session):
        trace.enable()
        try:
            _blocks(session, run, WARM_BLOCKS)
            since = time.perf_counter_ns()
            _blocks(session, run, n)
            rep = trace.report(since_ns=since)
        finally:
            trace.disable()
    seconds = time.perf_counter() - t0
    after = trace.totals()
    found = {"report": rep, "totals": totals, "blocks": n,
             "seconds": seconds,
             "capture_s": (after.get("graph.timed_capture", {})
                           .get("seconds", 0.0)
                           - totals.get("graph.timed_capture", {})
                           .get("seconds", 0.0)),
             "captures_inside": rep["spans"].get(
                 "graph.timed_capture", {}).get("count", 0),
             "missed": rep["stage_readings_missed"] - missed0}
    found["readings"] = readings(rep)
    run.note(note(found))
    return found


def readings(rep: dict) -> dict:
    """Each of :data:`READINGS` from a report of the stretch, ms a block
    (over its root spans' count) or a replay; None where the port or the
    device gives nothing to read."""
    from linrad_tpu_torch.utils import trace
    out = dict.fromkeys(READINGS)
    blocks = rep.get("blocks") or 0
    idle_ms = getattr(trace, "idle_ms", None)
    dev = rep.get("device") or {}
    if blocks and dev and idle_ms is not None:
        for name, prefixes in IDLE.items():
            out[name] = idle_ms(dev, *(prefixes or ())) / blocks
    stage_ms = rep.get("stage_ms") or {}
    for name, stage in STAGES.items():
        out[name] = stage_ms.get(stage)
    return out


def note(found: dict) -> str:
    """The stretch's stdout line."""
    rep = found["report"]
    dev = rep.get("device") or {}
    blocks = max(rep.get("blocks") or 0, 1)
    idle = {k: round(v / blocks, 6)
            for k, v in dev.get("idle_ms_by_span", {}).items()}
    stages = {k: round(v, 6) for k, v in rep.get("stage_ms", {}).items()}
    device_idle = found["readings"]["device_idle_ms_per_block"]
    return (f"rxbench: program trace {rep.get('blocks')} blocks after "
            f"{WARM_BLOCKS} warm ({found['blocks']} asked), "
            f"{found['seconds']:.4f} s with the twins' captures "
            f"{found['capture_s']:.4f} s; device idle ms a block "
            f"{device_idle} by innermost span {json.dumps(idle)}; stage ms "
            f"a replay {json.dumps(stages)} over {rep.get('stage_replays')} "
            f"replays; stage readings missed {found['missed']}; twin "
            f"captures inside the stretch {found['captures_inside']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 2
    from rxbench import core
    bench = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.find(bench["workloads"], args.workload, "workload")
    cfg = core.find(bench["configs"], cell["config"], "config")
    traffic = core.load_json(core.BENCH_DIR / "traffic"
                             / f"{cell['traffic']}.json")
    run = core.Run(cell, core.load_json(ROOT / cfg["file"]), traffic,
                   args.seed, args.seconds, True, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(int(args.seed) % (1 << 63))
    core.build_kernels(run)
    found = traced_run(run)
    for line in run.lines:
        print(line)
    print("program_trace: " + json.dumps(
        {"workload": args.workload, "seed": args.seed,
         "card": core.power_limit(), "torch": torch.__version__,
         "readings": found["readings"],
         "stage_ms": found["report"]["stage_ms"],
         "replay_ms": found["report"]["device"].get("replay_ms"),
         "idle_share": found["report"]["device"].get("idle_share"),
         "ms_per_block": found["report"]["ms_per_block"]}), flush=True)
    return 0


def traced_run(run) -> dict:
    """A traced run's set-up, window and slice on ``run``, then the
    stretch; its findings.  The session is released after."""
    entry = importlib.import_module(
        f"rxbench.entries.{run.traffic['entry']}")
    session = entry.setup(run)
    session.window(run.seconds, [])
    session.trace_slice()
    run.sync()
    found = stretch(session, run)
    session.release()
    return found


if __name__ == "__main__":
    sys.exit(main())
