"""The port's radar path against the benchmark's plain reference
(``rxbench/reference/weak/radar.py``), on device="cpu" at a small cut
(fft1 256, a shortened ``lock_after``, the pulse train every 16 frames):
``RadarFront.feed`` (the graph's body run eagerly, and the eager step)
into a ``RadarTracker``, block by block against ``PlainRadar`` on seeded
rings of the cell's generator (``rxbench/generators/radar_echo.py``).

The bars: on the CPU both sides take the same torch.fft, so the frames'
power agrees to 1e-6 (it is the same bits here), the peak bins and every
tracker decision exactly, S/N and floor to 1e-6 (the port sums the floor
in float32, the reference in float64), the display to 1e-6, the echo
exactly.  A fault planted in the reference's skirt walk (each walk one
step short) fails the cell's own limits.  Then the spans and counters
that ``weak/radar.py`` records under ``trace.enable()``, and the outputs
bit-identical with tracing on and off.  No JAX is imported."""

import json

import numpy as np
import pytest
import torch

from linrad_tpu_torch.params import RxParams
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.utils import trace
from linrad_tpu_torch.weak.radar import RadarFront, RadarParams, RadarTracker
from rxbench import core
from rxbench.entries import radar as entry
from rxbench.generators.radar_echo import make_ring
from rxbench.reference.receiver import make_params
from rxbench.reference.weak import radar as ref_radar

CONFIG = core.load_json(core.BENCH_DIR / "configs" / "radar-96k.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "moon.json")
LIMITS = core.load_json(core.BENCH_DIR / "limits" / "radar-96k.moon.json")
SMALL = dict(fft1_n_override=8, target_fft1_frames_per_step=8)
RING = dict(steps=8, pulse_period_frames=16, echo_delay_frames=12,
            echo_amplitude=1e-3)
RADAR = dict(CONFIG["radar"], lock_after=64)
BLOCKS = 12
BAR = 1e-6


def fields() -> dict:
    return {**CONFIG["params"], **SMALL}


def ring_blocks(seed: int) -> list:
    geo = ref_radar.derive_geometry(make_params(fields()))
    gen = torch.Generator().manual_seed(seed)
    x = make_ring(geo, {**TRAFFIC["ring"], **RING}, gen, 0.0)
    s = geo.samples_per_step
    return [x[i * s:(i + 1) * s] for i in range(x.shape[0] // s)]


def port(graphed: bool):
    rx = Receiver(RxParams.from_json(json.dumps(fields()), strict=True),
                  device="cpu", graphed=False)
    geo = rx.geo
    front = RadarFront.of_receiver(rx, graphed=graphed)
    tracker = RadarTracker(
        n_bins=geo.fft1_size,
        frame_time_s=geo.fft1_new_points / geo.timf1_sampling_speed,
        bin_hz=geo.timf1_sampling_speed / geo.fft1_size,
        params=RadarParams(**RADAR), device="cpu")
    return front, tracker


def reference():
    return ref_radar.PlainRadar(make_params(fields()),
                                ref_radar.RadarParams(**RADAR), "cpu")


def compared(graphed: bool, seed: int) -> list:
    """(readings, details) of every block: the port and the reference fed
    the same ring from fresh states."""
    front, tracker = port(graphed)
    ref = reference()
    frames = front.geo.fft1_frames_per_step
    out = []
    for k, block in enumerate((ring_blocks(seed) * 2)[:BLOCKS]):
        front.feed(tracker, block)
        got = entry.kept(tracker, frames)
        want = ref.feed(torch.from_numpy(block))
        out.append(entry.block_readings(got, want, ref.tracker,
                                        RADAR["mute_ratio"], k))
    assert tracker.locked and tracker.update_cnt >= 8
    assert tracker.pulse_sep == RING["pulse_period_frames"]
    assert front.graphed == graphed
    return out


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_port_against_the_reference(graphed, seed):
    records = compared(graphed, seed)
    for nums, info in records:
        assert info["ties"] == 0
        for name in ("power", "ston", "ston_tx", "noise_floor"):
            assert nums[name] <= BAR, (name, nums, info)
        assert nums["peak_bins"] == 0 and nums["tracker"] == 0, (nums, info)
        if "display" in nums:
            assert nums["display"] <= BAR and nums["echo"] == 0, (nums, info)
    assert sum("display" in nums for nums, _info in records) >= BLOCKS - 4
    assert sum(info["tx_frames"] for _nums, info in records) >= 4 * BLOCKS


def test_the_echo_where_the_ring_put_it():
    front, tracker = port(True)
    for block in ring_blocks(5):
        front.feed(tracker, block)
    line, off, _dopp = tracker.echo_peak()
    assert abs(line - RING["echo_delay_frames"]) <= 1
    assert off == TRAFFIC["ring"]["echo_doppler_bins"]


def test_a_walk_one_step_short_fails(monkeypatch):
    real = ref_radar.walk

    def short(row, k, direction, steps):
        i, margin = real(row, k, direction, steps)
        return (i - direction if i != k else i), margin

    monkeypatch.setattr(ref_radar, "walk", short)
    numbers = core.compare.aggregate(
        [("start", nums, info) for nums, info in compared(True, 3)])
    ok, checks = core.judge(numbers, LIMITS)
    assert not ok
    assert checks["noise_floor"]["value"] > LIMITS["noise_floor"]


def test_ties_give_no_reading():
    """A frame whose peak the reference found within rounding of a tie is
    judged neither by its peak bin nor by its S/N and floor."""
    f, n = 4, 64
    power = np.random.default_rng(0).random((f, n)).astype(np.float32) + 1
    power[1, 10] = power[1, 20] = 50.0
    want = ref_radar.pulse_stats(power)
    assert want["peak_margin"][1] == 0.0 and want["peak_margin"][0] > 1e-3
    want["power"] = power
    got = {"power": power, "peak_bin": want["peak_bin"].copy(),
           "ston": want["ston"].copy(), "noise_floor":
           want["noise_floor"].copy(), "decisions": {}, "display": None}
    got["peak_bin"][1] = 20
    got["ston"][1] *= 2
    tracker = ref_radar.RadarTracker(n_bins=n, frame_time_s=0.01)
    got["decisions"] = entry.decisions(tracker)
    nums, info = entry.block_readings(got, want, tracker, 0.1, 0)
    assert info["ties"] == 1
    assert nums["peak_bins"] == 0 and nums["ston"] == 0
    got["peak_bin"][2] += 1
    assert entry.block_readings(got, want, tracker, 0.1, 0)[0][
        "peak_bins"] == 1


@pytest.fixture
def tracer():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def run_blocks(graphed: bool, blocks: list):
    front, tracker = port(graphed)
    for block in blocks:
        front.feed(tracker, block)
    return front, tracker


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_spans_and_counters(tracer, graphed):
    blocks = ring_blocks(7)
    updates = trace.report()["counters"].get("radar_updates", 0)
    tracer.enable()
    front, tracker = run_blocks(graphed, blocks)
    tracer.disable()
    rep = trace.report()
    parents = {(r[0], r[1]) for r in trace.records()}
    step = "radar.replay" if graphed else "radar.step"
    want = {("radar.block", None), ("radar.h2d", "radar.block"),
            (step, "radar.block"), ("radar.track", "radar.block"),
            ("radar.read", "radar.track"), ("radar.lock", "radar.track"),
            ("radar.scan", "radar.track")}
    if graphed:
        want.add(("radar.owned", "radar.block"))
    assert parents == want
    assert rep["spans"]["radar.block"]["count"] == len(blocks)
    assert rep["blocks"] == len(blocks)
    frames, bins = front.geo.fft1_frames_per_step, front.geo.fft1_size
    block_bytes = blocks[0].nbytes
    assert rep["counters"]["d2h_bytes"] == len(blocks) * (
        frames * bins * 4 + frames * (8 + 4 + 4))
    # the blocks, and each display update's window of frames
    window = tracker.lines * (tracker.last_bin - tracker.first_bin) * 4
    assert rep["counters"]["h2d_bytes"] == len(blocks) * block_bytes \
        + tracker.update_cnt * window
    assert rep["counters"]["radar_updates"] - updates == tracker.update_cnt
    assert tracker.update_cnt > 0


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_outputs_bit_identical_with_tracing_on_and_off(tracer, graphed):
    blocks = ring_blocks(9)
    _f, off = run_blocks(graphed, blocks)
    tracer.enable()
    _f, on = run_blocks(graphed, blocks)
    tracer.disable()
    for name in entry.DECISIONS + ("decayfac", "_bins", "_ston", "_floor",
                                   "_consumed", "_next_scan"):
        assert getattr(on, name) == getattr(off, name), name
    np.testing.assert_array_equal(np.concatenate(on._hist_pw),
                                  np.concatenate(off._hist_pw))
    np.testing.assert_array_equal(on.average, off.average)
    assert on.echo_peak() == off.echo_peak()
