"""A later change adds a configuration, a traffic mix, a generator, an
entry and a per-layer metric as new files, and a cell that uses them, and
edits no file the benchmark has: a copy of it with those files added runs
the new cell and reports the new metric."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from rxbench import core


def digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_need_no_edit(tmp_path):
    bench_dir = tmp_path / "rxbench"
    shutil.copytree(core.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench_dir)
    cfg = core.load_json(core.BENCH_DIR / "configs" / "ssb-nb-96k.json")
    cfg = dict(cfg, name="ssb-nb-96k-am", params=dict(cfg["params"], demod=3))
    (bench_dir / "configs" / "ssb-nb-96k-am.json").write_text(
        json.dumps(cfg))
    mix = core.load_json(core.BENCH_DIR / "traffic" / "quiet.json")
    mix = dict(mix, entry="closed", generator="louder")
    (bench_dir / "traffic" / "loud.json").write_text(json.dumps(mix))
    (bench_dir / "generators" / "louder.py").write_text(
        "from rxbench.generators import keyed_tone\n\n\n"
        "def make_ring(geo, spec, gen, dial_hz):\n"
        "    return 2 * keyed_tone.make_ring(geo, spec, gen, dial_hz)\n")
    (bench_dir / "entries" / "closed.py").write_text(
        "from rxbench.entries.receiver import check, setup  # noqa: F401\n")
    (bench_dir / "metrics" / "fetch_ms_per_block.py").write_text(
        "LAYER = 'Host driver (pipeline/receiver.py)'\nUNIT = 'ms'\n"
        "SOURCE = 'host_clock'\nMOVES = 'block_latency_p95_ms'\n\n\n"
        "def read(traced):\n    return 1.0\n")
    (bench_dir / "end_to_end" / "blocks_per_s.py").write_text(
        "def read(window):\n"
        "    return window['stream_steps'] / window['window_s']\n")
    cell = "ssb-nb-96k-am.loud"
    shutil.copy(core.BENCH_DIR / "limits" / "ssb-nb-96k.quiet.json",
                bench_dir / "limits" / f"{cell}.json")
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "ssb-nb-96k-am", "source": "test",
                             "file": "rxbench/configs/ssb-nb-96k-am.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "ssb-nb-96k-am",
                               "traffic": "loud", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    bench["end_to_end"].append({"name": "blocks_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": [cell]})
    bench["per_layer"].append({
        "name": "fetch_ms_per_block", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "Host driver (pipeline/receiver.py)",
        "moves": "block_latency_p95_ms", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(core.ROOT)]))
    code = ("import json\nfrom rxbench.tests.tiny import run_tiny\n"
            f"res, _l, err = run_tiny({cell!r}, trace=True)\n"
            f"e2e, _l, _e = run_tiny({cell!r})\n"
            "print(json.dumps([res['correct'], sorted(res['metrics']),"
            " sorted(e2e['metrics'])]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, e2e = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "fetch_ms_per_block" in metrics
    assert e2e == ["block_latency_p95_ms", "blocks_per_s", "msamples_per_s",
                   "setup_s"]
    after = digests(bench_dir)
    assert {k: after[k] for k in before} == before
