"""The cell ``qrss-96k-spur.grabber``: its generator's ring is seeded and
has no seam, and the cell runs end to end at a small cut on the CPU (fft1
256, fft2 2,048, 8,192 samples a step, the ring's tones scaled to the
cut, the spur manager scanning every block on both sides as it does at
the configuration's own step of 5.46 s): correct against the plain
reference, with the spur manager's slots held exactly; not correct with
the port's bfloat16 fft1, nor with a fault planted in the port's spur
path (the manager's ages not carried from scan to scan, a slot a bin off,
the subtraction skipped).  Its two per-layer metrics read None where the
port has no ``spur.*`` spans.  The tests marked ``card`` run the cell at
its full size on a CUDA device, and skip here."""

import math
import time

import numpy as np
import pytest
import torch

from rxbench import core, tracing
from rxbench.generators import qrss_band
from rxbench.reference.geometry import derive_geometry
from rxbench.reference.receiver import make_params
from rxbench.tests.tiny import SEED

CELL = "qrss-96k-spur.grabber"
CONFIG = core.load_json(core.BENCH_DIR / "configs" / "qrss-96k-spur.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "grabber.json")
LIMITS = core.load_json(core.BENCH_DIR / "limits" / f"{CELL}.json")
METRICS = ("spur_search_ms_per_block", "spur_read_ms_per_block")
# the cut: fft2 bins of 46.9 Hz and 16 dB less gain in a bin than at full
# size, so the tones are louder and the birdies farther from the dial
RING = {"steps": 8, "element_s": 0.02, "target_amplitude": 0.5,
        "beacon_amp_lo": 0.05, "beacon_amp_hi": 0.1, "birdie_amp_lo": 0.5,
        "birdie_amp_hi": 2.0, "near_lo_hz": 1000.0, "near_hi_hz": 3000.0,
        "birdie_spacing_hz": 400.0, "birdie_drift_hz_per_s": 20.0}
SIZE = dict(fft1_n_override=8, target_fft1_frames_per_step=64, fft3_n=6,
            max_pulses_per_block=8, _ring=RING)


@pytest.fixture
def every_block(monkeypatch):
    """The spur manager scans every block, in the port and in the
    reference."""
    from linrad_tpu_torch.pipeline import control as port_control
    from rxbench.reference.pipeline import control as ref_control
    for cls in (port_control.WeakSignalControl,
                ref_control.WeakSignalControl):
        init = cls.__init__

        def patched(self, *a, _init=init, **k):
            _init(self, *a, **k)
            self.spur_scan_interval = 1

        monkeypatch.setattr(cls, "__init__", patched)


def run_small(seconds: float = 0.4, trace: bool = False,
              program: dict | None = None, seed: int = SEED):
    return core.run_cell(CELL, seed, seconds, trace, "cpu",
                         time.perf_counter(), size=SIZE, program=program)


def small_geo():
    return derive_geometry(make_params({**CONFIG["params"],
                                        **core.program_fields(SIZE)}))


def ring(seed: int, **spec) -> np.ndarray:
    s = {**TRAFFIC["ring"], **RING, **spec}
    return qrss_band.make_ring(small_geo(), s,
                               torch.Generator().manual_seed(seed),
                               TRAFFIC["dial_hz"])


QUIET = {"noise_sigma": 0.0, "target_amplitude": 0.0,
         "beacon_amp_lo": 1e-9, "beacon_amp_hi": 1e-9,
         "birdie_amp_lo": 1e-9, "birdie_amp_hi": 1e-9}


def test_ring_is_seeded():
    a, b, c = ring(3), ring(3), ring((1 << 31) + 3)
    geo = small_geo()
    assert a.shape == (RING["steps"] * geo.samples_per_step, 1)
    assert a.dtype == np.complex64
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def cyclic_rate(x: np.ndarray) -> np.ndarray:
    """Phase advance of each sample to the next, the last to the first."""
    return np.angle(np.roll(x, -1) * np.conj(x))


def test_a_drifting_birdie_has_no_seam():
    spec = dict(QUIET, birdies_near=0, birdies_far=1, birdie_amp_lo=1.0,
                birdie_amp_hi=1.0, birdie_drift_hz_per_s=2.0)
    x = ring(5, **spec)[:, 0].astype(np.complex128)
    rate = cyclic_rate(x)
    step = np.abs(np.diff(np.append(rate, rate[0])))
    assert step.max() < 1e-4
    # and it does drift: f0 + A sin(2 pi t / T), A 2 pi / T the peak rate
    fs = small_geo().timf1_sampling_speed
    peak_hz = 2.0 * (len(x) / fs) / (2 * np.pi)
    assert np.ptp(rate) == pytest.approx(2 * 2 * np.pi * peak_hz / fs,
                                         rel=0.05)
    np.testing.assert_allclose(np.abs(x), 1.0, rtol=1e-6)


def test_the_keyed_beacon_has_no_seam():
    """The target alone: on in whole elements of the message, which
    divides the ring, the last element off; its phase moves smoothly
    wherever it is on, across the wrap too."""
    spec = dict(QUIET, target_amplitude=1.0, target_drift_hz_per_s=2.0)
    geo = small_geo()
    s = {**TRAFFIC["ring"], **RING, **spec}
    lay = qrss_band.layout(geo, s, torch.Generator().manual_seed(7),
                           TRAFFIC["dial_hz"])
    x = ring(7, **spec)[:, 0].astype(np.complex128)
    length = len(x)
    key = lay["key"][0]
    elem = (np.arange(length) * len(key)) // length
    np.testing.assert_allclose(np.abs(x), key[elem], atol=1e-5)
    assert key[-1] == 0 and key.max() == 1
    on = np.abs(x) > 0.5
    both = on & np.roll(on, -1)
    rate = cyclic_rate(x)[both]
    assert np.abs(np.diff(rate)).max() < 1e-4


def test_the_cell_runs_at_the_small_cut(every_block, monkeypatch):
    from rxbench.entries import spur as entry
    slices = []
    real = entry.Session.trace_slice
    monkeypatch.setattr(entry.Session, "trace_slice",
                        lambda self: slices.append(real(self)) or slices[-1])
    result, lines, err = run_small(trace=True)
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(LIMITS)
    assert sorted(result["metrics"]) == sorted(METRICS)
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert any("AFC status 3" in line for line in lines)
    held = next(line for line in lines if "spur slots active" in line)
    assert int(held.split(": ")[2].split(",")[0]) >= 6
    assert any("spur manager in the window: spur_scans" in line
               for line in lines)
    (traced,) = slices
    assert traced.stream_steps == TRAFFIC["trace_blocks"]
    e2e, _lines, _err = run_small()
    assert sorted(e2e["metrics"]) == ["msamples_per_s", "setup_s"]


def test_lower_precision_fails(every_block):
    result, _lines, err = run_small(program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err


def test_ages_not_carried_are_not_correct(every_block, monkeypatch):
    """The port's manager forgets its slots' ages before each scan."""
    from linrad_tpu_torch.weak.spur import SpurManager
    real = SpurManager.scan

    def forgetful(self, *a, **k):
        self._age.clear()
        return real(self, *a, **k)

    monkeypatch.setattr(SpurManager, "scan", forgetful)
    result, _lines, err = run_small()
    assert not result["correct"], err
    assert result["checks"]["spur_bins"]["value"] > 0


def test_a_slot_a_bin_off_is_not_correct(every_block, monkeypatch):
    """Each scan leaves the port's first active slot a bin above where the
    manager put it."""
    from linrad_tpu_torch.weak.spur import SpurManager
    real = SpurManager.scan

    def off(self, *a, **k):
        new = real(self, *a, **k)
        active = torch.nonzero(new.bins >= 0).reshape(-1)
        if len(active):
            new.bins[active[0]] += 1
        return new

    monkeypatch.setattr(SpurManager, "scan", off)
    result, _lines, err = run_small()
    assert not result["correct"], err
    assert result["checks"]["spur_bins"]["value"] > 0


def test_the_subtraction_skipped_is_not_correct(every_block, monkeypatch):
    """The port's chain leaves the spectra and the slots' model as they
    came."""
    from linrad_tpu_torch.pipeline import chain
    monkeypatch.setattr(chain, "spur_subtract_step",
                        lambda geo, tpl, state, spectra: (state, spectra))
    result, _lines, err = run_small()
    assert not result["correct"], err
    checks = result["checks"]
    assert checks["fft2_power"]["value"] > checks["fft2_power"]["limit"]
    assert checks["spur_model"]["value"] > checks["spur_model"]["limit"]


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_read_none_without_the_spans(metric, monkeypatch):
    import rxbench.program_spans as spans
    monkeypatch.setattr(spans, "totals", lambda: {
        "rx.block": {"count": 4, "seconds": 0.04}})
    assert core.load_metric(metric).read(tracing.Traced()) is None
    monkeypatch.setattr(spans, "totals", lambda: {})
    assert core.load_metric(metric).read(tracing.Traced()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_read_the_ports_spans(metric, monkeypatch):
    import rxbench.program_spans as spans
    monkeypatch.setattr(spans, "totals", lambda: {
        "rx.block": {"count": 4, "seconds": 0.04},
        "spur.read": {"count": 8, "seconds": 0.008},
        "spur.write": {"count": 4, "seconds": 0.004},
        "spur.search": {"count": 4, "seconds": 0.02}})
    want = {"spur_search_ms_per_block": 5.0,
            "spur_read_ms_per_block": 3.0}[metric]
    assert math.isclose(core.load_metric(metric).read(tracing.Traced()),
                        want)


@pytest.mark.card
def test_cell_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED, 2.0, True, card,
                                        time.perf_counter())
    assert result["correct"], err
    assert result["device"]["platform"] == "gpu"
    assert set(METRICS) <= set(result["metrics"])


@pytest.mark.card
def test_control_fails_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED + 1, 1.0, False, card,
                                        time.perf_counter(),
                                        program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err
