"""The cell ``radar-96k.moon``: its generator's ring is seamless, and the
cell runs end to end at a small cut on the CPU (fft1 256, the pulse
train every 16 frames, a shortened ``lock_after``): correct against the
plain reference, not correct with the port's bfloat16 fft1 or with its
radar path broken underneath.  The tests marked ``card`` run the cell at
its full size on a CUDA device, and skip here."""

import time

import numpy as np
import pytest
import torch

from rxbench import core
from rxbench.generators import radar_echo
from rxbench.reference.geometry import derive_geometry
from rxbench.reference.receiver import make_params
from rxbench.tests.tiny import SEED

CELL = "radar-96k.moon"
CONFIG = core.load_json(core.BENCH_DIR / "configs" / "radar-96k.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "moon.json")
RING = dict(steps=8, pulse_period_frames=16, echo_delay_frames=12,
            echo_amplitude=1e-3)
SIZE = dict(fft1_n_override=8, target_fft1_frames_per_step=8, _ring=RING,
            _radar=dict(lock_after=64))


def run_small(seconds: float = 0.6, trace: bool = False,
              program: dict | None = None, seed: int = SEED):
    return core.run_cell(CELL, seed, seconds, trace, "cpu",
                         time.perf_counter(), size=SIZE, program=program)


def small_geo():
    return derive_geometry(make_params({**CONFIG["params"],
                                        **core.program_fields(SIZE)}))


@pytest.mark.parametrize("seed", [1, SEED])
def test_ring_is_seamless(seed):
    """With the noise off: the envelope repeats every pulse period around
    the ring, the pulses start on the frame grid, and every pulse's echo,
    the last one's wrapped to the ring's start, lies where the traffic
    puts it."""
    geo = small_geo()
    spec = {**TRAFFIC["ring"], **RING, "noise_sigma": 0.0}
    x = radar_echo.make_ring(geo, spec, torch.Generator().manual_seed(seed),
                             0.0)[:, 0]
    hop = geo.fft1_new_points
    period = spec["pulse_period_frames"] * hop
    length = spec["steps"] * geo.samples_per_step
    assert x.shape == (length,) and length % period == 0
    mag = np.abs(x)
    np.testing.assert_allclose(np.roll(mag, period), mag, atol=1e-6)
    starts = radar_echo.pulse_starts(geo, spec,
                                     torch.Generator().manual_seed(seed))
    assert len(starts) == length // period and np.all(starts % hop == 0)
    width = spec["pulse_width_frames"] * hop
    delay = spec["echo_delay_frames"] * hop
    for s in starts:
        np.testing.assert_allclose(mag[(s + width // 2) % length], 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(mag[(s + delay + width // 2) % length],
                                   spec["echo_amplitude"], rtol=1e-4)


def test_a_period_that_does_not_divide_the_ring_is_refused():
    spec = {**TRAFFIC["ring"], **RING, "pulse_period_frames": 24}
    with pytest.raises(ValueError, match="does not divide"):
        radar_echo.make_ring(small_geo(), spec, torch.Generator(), 0.0)


def test_the_cell_runs_at_the_small_cut(monkeypatch):
    from rxbench.entries import radar as entry
    slices = []
    real = entry.Session.trace_slice
    monkeypatch.setattr(entry.Session, "trace_slice",
                        lambda self: slices.append(real(self)) or slices[-1])
    result, lines, err = run_small(trace=True)
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0
    assert "radar_track_ms_per_block" in result["metrics"]
    # the slice carries the fused fft1's shape, so that the kernel's
    # roofline share reads this cell once it lists it
    (traced,) = slices
    geo = small_geo()
    assert traced.shapes["fft1"] == (geo.fft1_frames_per_step,
                                     geo.fft1_size, geo.channels)
    traced.ops.append(("fused_fft1_kernel", 1e-3))
    assert core.load_metric("fft1_roofline_share").read(traced) > 0
    assert set(result["checks"]) == set(core.load_json(
        core.BENCH_DIR / "limits" / f"{CELL}.json"))
    assert any("tracker locked True" in line for line in lines)
    e2e, _lines, _err = run_small()
    assert sorted(e2e["metrics"]) == ["msamples_per_s", "setup_s"]


def test_lower_precision_fails():
    result, _lines, err = run_small(program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err


def stale_state(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def stale(tables, state, block):
            _new, out = step(tables, state, block)
            return state, out
        return stale
    return make


def altered_power(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def altered(tables, state, block):
            new, (power, *stats) = step(tables, state, block)
            power = power.clone()
            power[power.shape[0] // 2] *= 1.001
            return new, (power, *stats)
        return altered
    return make


@pytest.mark.parametrize("fault", [stale_state, altered_power])
def test_broken_path_is_not_correct(fault, monkeypatch):
    from linrad_tpu_torch.weak import radar as mod
    monkeypatch.setattr(mod, "radar_step", fault(mod.radar_step))
    result, _lines, err = run_small()
    assert not result["correct"], err


def test_a_tracker_that_skips_a_display_update_is_not_correct(monkeypatch):
    from linrad_tpu_torch.weak import radar as mod
    real = mod._accumulate
    calls = {"n": 0}

    def skip_fifth(avg, *args):
        calls["n"] += 1
        return avg if calls["n"] == 5 else real(avg, *args)

    monkeypatch.setattr(mod, "_accumulate", skip_fifth)
    result, _lines, err = run_small()
    assert not result["correct"], err


@pytest.mark.card
def test_cell_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED, 2.0, True, card,
                                        time.perf_counter())
    assert result["correct"], err
    assert result["device"]["platform"] == "gpu"
    assert {"radar_track_ms_per_block", "radar_kernels_per_block",
            "radar_device_ms_per_block"} <= set(result["metrics"])


@pytest.mark.card
def test_control_fails_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED + 1, 1.0, False, card,
                                        time.perf_counter(),
                                        program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err
