"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or linrad_tpu (compared whole: linrad_tpu_torch is the
port), and a reference that loads nothing of the port either; and a
measurement path that refuses to run without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from rxbench import core

ROOT = core.ROOT
REF = core.BENCH_DIR / "reference"


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nimport json; print(json.dumps(sorted("
         f"{{m.partition('.')[0] for m in sys.modules}})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = loaded_after(
        "from rxbench.tests.tiny import run_tiny\n"
        "run_tiny('wcw-eme-48k-xy.drift', trace=True)\n"
        "run_tiny('ssb-nb-96k.fleet8', seconds=0.2)\n"
        "from rxbench import core\n"
        "for m in core.load_json(core.ROOT / 'BENCHMARK.json')['per_layer']:"
        "\n    core.load_metric(m['name'])\n"
        "assert not core.forbidden_loaded()")
    assert "linrad_tpu_torch" in tops and "rxbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "linrad_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    mods = sorted("rxbench.reference." + ".".join(
        p.relative_to(REF).with_suffix("").parts)
        for p in REF.rglob("*.py") if p.name != "__init__.py")
    tops = loaded_after("import importlib\n" + "\n".join(
        f"importlib.import_module({m!r})" for m in mods))
    assert not tops & {"jax", "jaxlib", "flax", "linrad_tpu",
                       "linrad_tpu_torch"}


def test_the_reference_imports_are_relative():
    allowed = {"__future__", "dataclasses", "enum", "json", "math",
               "functools", "numpy", "scipy", "torch", "typing",
               "contextlib"}
    for path in REF.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.partition(".")[0] in allowed, (path, n)


def run_py(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "rxbench/run.py", "--workload",
         "ssb-nb-96k.impulsive", "--seed", str((1 << 31) + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=600)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(ROOT, env)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_py(tmp_path, env)
    assert out.returncode != 0 and not out.stdout.strip()
