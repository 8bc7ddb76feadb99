"""The generators: seeded, and their rings without a seam in phase,
frequency or keying, so the replay's wrap-around is one more sample
boundary."""

import numpy as np
import pytest

from rxbench import core, ring
from rxbench.tests.tiny import TINY

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")


def cell_parts(cell: str):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = core.load_json(core.ROOT / next(
        c for c in BENCH["configs"] if c["name"] == w["config"])["file"])
    t = core.load_json(core.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    run = core.Run(w, cfg, t, 5, 1.0, False, "cpu", size=dict(TINY))
    from rxbench.reference.geometry import derive_geometry
    return run, derive_geometry(run.reference_params())


def make(cell: str, seed: int, **spec):
    run, geo = cell_parts(cell)
    s = {**run.traffic["ring"], "steps": 8, **spec}
    dial = run.traffic.get("dial_hz") or run.traffic["dials_hz"][0]
    return run.generator().make_ring(
        geo, s, core.torch_generator(seed, "cpu", 1), dial), geo


@pytest.mark.parametrize("cell", ["ssb-nb-96k.impulsive",
                                  "wcw-eme-48k-xy.drift",
                                  "ssb-nb-96k.quiet"])
def test_ring_is_seeded(cell):
    a, geo = make(cell, 3)
    b, _ = make(cell, 3)
    c, _ = make(cell, (1 << 31) + 3)
    assert a.shape == (8 * geo.samples_per_step, geo.channels)
    assert a.dtype == np.complex64
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def cyclic_rate(x: np.ndarray) -> np.ndarray:
    """Phase advance of each sample to the next, the last to the first."""
    return np.angle(np.roll(x, -1) * np.conj(x))


QUIET = dict(noise_sigma=0.0, impulses_per_step=0, key_on_elements=4)


@pytest.mark.parametrize("what", ["tone", "carrier"])
def test_flagship_carriers_have_no_seam(what):
    spec = dict(QUIET, tone_amplitude=0.0 if what == "carrier" else 10.0,
                carrier_amplitude=0.0 if what == "tone" else 2000.0)
    x, _ = make("ssb-nb-96k.impulsive", 1, **spec)
    rate = cyclic_rate(x[:, 0].astype(np.complex128))
    assert np.ptp(rate) < 1e-4


def test_eme_drift_has_no_seam():
    x, _ = make("wcw-eme-48k-xy.drift", 1, carrier_amplitude=0.0, **QUIET)
    rate = cyclic_rate(x[:, 0].astype(np.complex128))
    # the frequency moves smoothly everywhere, across the wrap too
    step = np.abs(np.diff(np.append(rate, rate[0])))
    assert step.max() < 1e-4
    assert np.ptp(rate) > 0        # and it does drift


@pytest.mark.parametrize("on", [2, 3])
def test_keying_divides_the_ring(on):
    fs, length = 96_000.0, 8 * 1024
    key = ring.keying(0.003, on, fs, length, "cpu").numpy()
    edges = np.flatnonzero(np.diff(np.append(key, key[0])))
    runs = np.diff(np.append(edges, edges[0] + length))
    assert key[0] == 1 and key[-1] == 0
    assert np.ptp(runs[key[(edges + 1) % length] == 1]) <= 1
    assert np.ptp(runs[key[(edges + 1) % length] == 0]) <= 1
