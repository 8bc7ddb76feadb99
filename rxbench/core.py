"""One run of one cell: set-up, the measured window, the traced slice,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric lives in a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (which names its ``generators/<generator>.py`` and
``entries/<entry>.py``), ``limits/<cell>.json``, ``end_to_end/<metric>.py``
and ``metrics/<metric>.py``.  This module knows none of them by name.
"""

from __future__ import annotations

import importlib
import json
import math
import platform
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from rxbench import compare

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded when the window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "linrad_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"rxbench: no {what} named {name!r} in BENCHMARK.json")


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator from the run's seed (any whole number) and a salt."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def torch_generator(seed: int, device, *salt: int):
    """A torch generator on ``device`` from the run's seed and a salt."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng_for(seed, *salt).integers(0, 1 << 62)))
    return gen


@dataclass
class Run:
    """What one run of a cell knows: the cell's files, the seed, the
    device, and overrides of the parameters: ``size`` for both sides (a
    test's tiny cut), ``program`` for the port alone (the control's lower
    precision)."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    size: dict = field(default_factory=dict)
    program: dict = field(default_factory=dict)
    lines: list = field(default_factory=list)
    marks: list = field(default_factory=list)

    def program_params(self):
        from linrad_tpu_torch.params import RxParams
        fields = {**self.config["params"], **program_fields(self.size),
                  **self.program}
        return RxParams.from_json(json.dumps(fields), strict=True)

    def reference_params(self):
        from rxbench.reference.receiver import make_params
        return make_params({**self.config["params"],
                            **program_fields(self.size)})

    def generator(self):
        return importlib.import_module(
            f"rxbench.generators.{self.traffic['generator']}")

    def ring_spec(self) -> dict:
        """The generator's parameters, with a test's shorter ring."""
        spec = dict(self.traffic["ring"])
        spec.update(self.size.get("_ring", {}))
        return spec

    def mark(self, label: str) -> None:
        """The end of a part of set-up, for the line that splits it."""
        self.marks.append((label, time.perf_counter()))

    def note(self, text: str) -> None:
        """A line for standard output, before the result."""
        self.lines.append(text)

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()


def program_fields(size: dict) -> dict:
    """The parameter fields of a size override (``_ring`` is the
    generator's)."""
    return {k: v for k, v in size.items() if not k.startswith("_")}


def sample_times(seed: int, seconds: float, n: int) -> list[float]:
    """Seconds into the window at which the entry keeps a block for the
    check: drawn from the seed, so any rate samples inside the window."""
    return sorted(float(t) for t in
                  rng_for(seed, 7).uniform(0.05, 0.95, n) * seconds)


def build_kernels(run: Run) -> float:
    """Build (or find built) the port's three kernels, as its first use
    would, so that the first run's nvcc seconds are reported apart."""
    if not run.device.startswith("cuda"):
        return 0.0
    from linrad_tpu_torch.utils import cuda_build
    built = cuda_build.build_all()
    return max(info["build_seconds"] for _lib, info in built.values())


def forbidden_loaded() -> list[str]:
    return sorted({name.partition(".")[0] for name in sys.modules}
                  & set(FORBIDDEN_MODULES))


def device_info(run: Run) -> dict:
    import torch
    if not run.device.startswith("cuda"):
        return {"platform": "cpu", "kind": platform.processor() or "cpu",
                "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; a number without a limit,
    or not a finite number, fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and math.isfinite(value)
                and value <= limit)
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def load_metric(name: str, kind: str = "metrics"):
    """The reader of a metric: ``metrics/<name>.py`` (per layer) or
    ``end_to_end/<name>.py``."""
    return importlib.import_module(
        f"rxbench.{kind}.{name.replace('.', '_').replace('-', '_')}")


def read_metrics(entries: list, cell: str, kind: str, source) -> dict:
    """Each metric of ``entries`` that this cell reports, by its reader."""
    out = {}
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_metric(m["name"], kind).read(source)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, size: dict | None = None,
             program: dict | None = None, bench: dict | None = None,
             keep_records: bool = False) -> tuple[dict, list[str], str]:
    """One run of a cell.  Returns (the result object, the lines before
    it, the comparison's lines for standard error); ``keep_records`` adds
    every compared stream-step's readings to the result as ``records``."""
    import torch
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], cell_name, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "config")
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    run = Run(cell, config, traffic, seed, seconds, trace, device,
              dict(size or {}), dict(program or {}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(int(seed) % (1 << 63))
    entry = importlib.import_module(f"rxbench.entries.{traffic['entry']}")

    run.marks.append(("start", t_start))
    run.mark("imports")
    nvcc_s = build_kernels(run)
    run.mark("kernels")
    session = entry.setup(run)
    run.sync()
    run.mark("warm-up")
    setup_s = time.perf_counter() - t_start
    win = session.window(seconds, sample_times(
        seed, seconds, traffic["check"]["window_samples"]))
    traced = session.trace_slice() if trace else None
    run.sync()
    dev = device_info(run)
    data = session.release()
    del session
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    records = compare.judged(entry.check(run, data))
    ref_s = time.perf_counter() - t_ref
    limits = load_json(BENCH_DIR / "limits" / f"{cell_name}.json")
    numbers = compare.aggregate(records)
    correct, checks = judge(numbers, limits)
    compared = len(records)
    in_window = [nums for kind, nums, _info in records if kind == "window"]
    # a window that closed before it kept a block judges nothing of it
    correct = correct and bool(in_window)
    failed = sum(1 for nums in in_window if compare.step_fails(nums, limits))
    win["setup_s"] = setup_s

    lat = win["latencies_s"]
    run.note(f"rxbench: card {dev['kind']} x {dev['count']}; "
             f"{power_limit() if dev['platform'] == 'gpu' else 'no card'}; "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"Python {platform.python_version()}")
    run.note(f"rxbench: first run's nvcc seconds {nvcc_s:.2f} "
             f"(0 when the kernels were already built; inside setup_s "
             f"{setup_s:.3f})")
    run.note(f"rxbench: window {win['window_s']:.4f} s, "
             f"{win['stream_steps']} stream-steps timed, "
             f"{len(lat)} latency samples, peak device memory "
             f"{dev['memory_peak_bytes']} bytes, reference check "
             f"{ref_s:.2f} s over {compared} compared stream-steps")
    run.note("rxbench: set-up seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(run.marks, run.marks[1:])))
    if lat:
        run.note(f"rxbench: block latency ms median "
                 f"{1e3 * statistics.median(lat):.4f}, max "
                 f"{1e3 * max(lat):.4f} over {len(lat)} blocks")

    if trace:
        metrics = read_metrics(bench["per_layer"], cell_name, "metrics",
                               traced)
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        run.note(f"rxbench: traced slice {traced.window_s:.4f} s, "
                 f"{traced.stream_steps} stream-steps, device busy "
                 f"{traced.busy_s:.4f} s; {traced.notes}")
    else:
        metrics = read_metrics(bench["end_to_end"], cell_name, "end_to_end",
                               win)

    result = {"correct": bool(correct),
              "attempted": int(win["stream_steps"]), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = traced.breakdown
    if keep_records:
        result["records"] = records
    result["checks"] = checks
    err = [f"check {name}: {c['value']:.6g} limit {c['limit']}"
           for name, c in checks.items()]
    err.append(f"check correct: {result['correct']} ({failed} of the "
               f"window's {len(in_window)} compared stream-steps over a "
               f"limit, at least 1 compared; {compared} compared in all)")
    return result, run.lines, "\n".join(err)
