"""What decides ``correct``, at the tiny cut on the CPU: the port and the
frozen plain reference agree within every limit; the port's lower
precision (its bfloat16 fft1, the control) does not; and a run with the
timed path broken underneath comes out not correct, for each fault a
cell can have: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced; and so does a fault
confined to one stream, one block or one step of a call."""

import dataclasses

import pytest
import torch

from rxbench.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(cell):
    result, _lines, err = run_tiny(cell)
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_fails(cell):
    result, _lines, err = run_tiny(cell, program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err


def stale_state(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def stale(tables, state, *args):
            _new, out = step(tables, state, *args)
            return state, out
        return stale
    return make


def half_block(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def half(tables, state, block, *args):
            kept = block.clone()
            kept[block.shape[0] // 2:] = 0
            return step(tables, state, kept, *args)
        return half
    return make


def altered_audio(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def altered(tables, state, *args):
            new, out = step(tables, state, *args)
            audio = out.audio.clone()
            mid = audio.shape[0] // 2
            audio[mid] = audio[mid] + 0.05 * audio.abs().max()
            return new, dataclasses.replace(out, audio=audio)
        return altered
    return make


def half_streams(make_fleet_step):
    def make(*a, **k):
        step = make_fleet_step(*a, **k)

        def half(tables, state, blocks, *args):
            kept = blocks.clone()
            kept[blocks.shape[0] // 2:] = 0
            return step(tables, state, kept, *args)
        return half
    return make


FAULTS = {"stale_state": stale_state, "half_batch": half_block,
          "altered_answer": altered_audio}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    if "fleet" in cell:
        from linrad_tpu_torch.parallel import fleet as mod
        if fault == "half_batch":
            monkeypatch.setattr(mod, "make_fleet_step",
                                half_streams(mod.make_fleet_step))
        else:
            monkeypatch.setattr(mod, "make_rx_step",
                                FAULTS[fault](mod.make_rx_step))
    else:
        from linrad_tpu_torch.pipeline import receiver as mod
        monkeypatch.setattr(mod, "make_rx_step",
                            FAULTS[fault](mod.make_rx_step))
    result, _lines, err = run_tiny(cell)
    assert not result["correct"], err


def test_a_fault_after_the_start_shows_in_the_window(monkeypatch):
    """The window's samples are judged on their own: a step that goes
    wrong only after set-up (past the start's steps) fails the run."""
    from linrad_tpu_torch.pipeline import receiver as mod
    real = mod.make_rx_step
    calls = {"n": 0}

    def make(*a, **k):
        step = real(*a, **k)

        def late(tables, state, block, *args):
            calls["n"] += 1
            new, out = step(tables, state, block, *args)
            if calls["n"] > 24:        # the set-up's blocks (warmup_blocks)
                out = dataclasses.replace(out, audio=torch.zeros_like(
                    out.audio))
            return new, out
        return late

    monkeypatch.setattr(mod, "make_rx_step", make)
    result, _lines, err = run_tiny("ssb-nb-96k.impulsive", seconds=1.0)
    assert not result["correct"], err
    assert "check audio: 1 " in err


def test_one_window_block_broken_is_not_correct(monkeypatch):
    """An answer altered in one block of the window alone, the first block
    that the window keeps for the check, fails the run."""
    from linrad_tpu_torch.pipeline import receiver as mod
    from rxbench.entries import receiver as entry
    real_step, real_snapshot = mod.make_rx_step, entry.Session.snapshot
    armed = {"on": False, "hit": 0}

    def snapshot(self):
        if not armed["hit"]:
            armed["on"] = True
        return real_snapshot(self)

    monkeypatch.setattr(entry.Session, "snapshot", snapshot)
    monkeypatch.setattr(mod, "make_rx_step", altered_audio_when(
        real_step, armed))
    result, _lines, err = run_tiny("ssb-nb-96k.impulsive", seconds=1.0)
    assert armed["hit"] == 1
    assert not result["correct"], err
    assert audio_over_its_limit(result), err


def audio_over_its_limit(result) -> bool:
    """The audio's own number fails: the fault shows where it was made,
    not only in a field it disturbs on the way."""
    audio = result["checks"]["audio"]
    return audio["value"] > audio["limit"]


def altered_audio_when(make_step, armed):
    def make(*a, **k):
        step = altered_audio(make_step)(*a, **k)
        plain = make_step(*a, **k)

        def once(*args):
            if armed["on"]:
                armed["on"] = False
                armed["hit"] += 1
                return step(*args)
            return plain(*args)
        return once
    return make


def test_one_fleet_stream_mistuned_is_not_correct(monkeypatch):
    """One stream of the fleet tuned a quarter of an fftx bin off its dial,
    within the bin, so that the wideband fields (the protected passband
    among them) stay right, and the others right: the narrowband fields
    fail the run, since every stream is compared."""
    import numpy as np

    from linrad_tpu_torch.parallel.fleet import FleetRunner
    real = FleetRunner.tune

    def tune(self, freqs_hz):
        f = np.array(freqs_hz, np.float64)
        width = self.geo.timf1_sampling_speed / self.geo.fftx_size
        frac = f[-1] / width - np.round(f[-1] / width)
        f[-1] += (-0.25 if frac > 0 else 0.25) * width
        return real(self, f)

    monkeypatch.setattr(FleetRunner, "tune", tune)
    result, _lines, err = run_tiny("ssb-nb-96k.fleet8")
    assert not result["correct"], err
    assert audio_over_its_limit(result), err


def test_a_late_step_of_a_fleet_call_is_judged(monkeypatch):
    """An answer altered only in the last of a fleet call's K steps fails
    the run: every step of a sampled call is compared."""
    import json

    from linrad_tpu_torch.parallel import fleet as mod
    from rxbench.core import BENCH_DIR
    k = json.loads((BENCH_DIR / "traffic" / "fleet8.json").read_text())[
        "k_steps"]
    real = mod.make_fleet_step
    calls = {"n": 0}

    def make(*a, **kw):
        step = real(*a, **kw)
        bad = altered_audio(lambda *a2, **k2: step)()

        def last_of_call(*args):
            calls["n"] += 1
            return (bad if calls["n"] % k == 0 else step)(*args)
        return last_of_call

    monkeypatch.setattr(mod, "make_fleet_step", make)
    result, _lines, err = run_tiny("ssb-nb-96k.fleet8")
    assert calls["n"] % k == 0
    assert not result["correct"], err
    assert audio_over_its_limit(result), err
