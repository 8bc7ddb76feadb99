"""The benchmark's files: BENCHMARK.json as the contract and the cells'
files ask, every configuration and traffic mix loading and building its
parameters and geometry on both sides, every per-layer metric's reader
declaring what BENCHMARK.json says of it."""

import json
import re

import pytest

from rxbench import core

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rxbench/run.py"]
    assert BENCH["paths"] == ["rxbench"]
    assert [c["name"] for c in BENCH["configs"]] == ["ssb-nb-96k",
                                                      "wcw-eme-48k-xy"]
    assert [w["name"] for w in BENCH["workloads"]] == [
        "ssb-nb-96k.impulsive", "wcw-eme-48k-xy.drift", "ssb-nb-96k.quiet",
        "ssb-nb-96k.fleet8"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])
    for w in BENCH["workloads"]:
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_metric_has_a_reader(metric):
    assert callable(core.load_metric(metric, "end_to_end").read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_declares_its_entry(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = core.load_metric(metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_builds_params_and_geometry(config):
    from linrad_tpu_torch.geometry import derive_geometry as port_geo
    from rxbench.reference.geometry import derive_geometry as ref_geo
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = core.load_json(core.ROOT / entry["file"])
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert set(cfg["assumed"]) <= set(cfg["params"])
    cell = next(w for w in BENCH["workloads"] if w["config"] == config)
    run = core.Run(cell, cfg, {}, 1, 1.0, False, "cpu")
    port, ref = run.program_params(), run.reference_params()
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    g1, g2 = port_geo(port), ref_geo(ref)
    assert g1.samples_per_step == g2.samples_per_step
    assert g1.__dict__ == g2.__dict__


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    import importlib
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    t = core.load_json(core.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    importlib.import_module(f"rxbench.entries.{t['entry']}")
    importlib.import_module(f"rxbench.generators.{t['generator']}")
    limits = core.load_json(core.BENCH_DIR / "limits" / f"{cell}.json")
    assert limits and all(v >= 0 for v in limits.values())
