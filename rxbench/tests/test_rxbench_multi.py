"""The cell ``ssb-multi24-2msps.band``: its generator's ring is
deterministic from the seed and lays the band out where the traffic says,
and the cell runs end to end at the tiny cut on the CPU (fft1 256, 2,048
samples a step, the 24 sub-receivers): correct against the plain
reference, not correct with the port's bfloat16 fft1, with a stale
sub-receiver state or with one sub-receiver a bin off.  Its three
per-layer metrics read None where the port has no spans and the slice no
kernels.  The tests marked ``card`` run the cell at its full size on a
CUDA device, and skip here."""

import time

import numpy as np
import pytest
import torch

from rxbench import core, tracing
from rxbench.generators import band
from rxbench.reference.geometry import derive_geometry
from rxbench.reference.receiver import make_params
from rxbench.tests.tiny import SEED, TINY

CELL = "ssb-multi24-2msps.band"
CONFIG = core.load_json(core.BENCH_DIR / "configs" / "ssb-multi24-2msps.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "band.json")
SIZE = dict(TINY, _ring={"steps": 8})
METRICS = ("band_h2d_ms_per_block", "band_owned_ms_per_block",
           "update_roofline_share")


def run_small(seconds: float = 0.6, trace: bool = False,
              program: dict | None = None, seed: int = SEED):
    return core.run_cell(CELL, seed, seconds, trace, "cpu",
                         time.perf_counter(), size=SIZE, program=program)


def small_geo():
    return derive_geometry(make_params({**CONFIG["params"],
                                        **core.program_fields(SIZE)}))


def quiet_spec() -> dict:
    return {**TRAFFIC["ring"], **SIZE["_ring"], "noise_sigma": 0.0,
            "impulses_per_step": 0}


@pytest.mark.parametrize("seed", [1, SEED])
def test_ring_is_deterministic_from_the_seed(seed):
    geo = small_geo()
    spec = {**TRAFFIC["ring"], **SIZE["_ring"]}
    a, b, c = (band.make_ring(geo, spec, torch.Generator().manual_seed(s),
                              0.0) for s in (seed, seed, seed + 1))
    assert a.shape == (spec["steps"] * geo.samples_per_step, 1)
    assert a.dtype == np.complex64
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", [1, SEED])
def test_stations_and_carriers_where_the_spec_puts_them(seed):
    """Without noise and impulses: each station, on an fftx bin in its own
    slot, keyed half the time, reads half its amplitude in its bin of the
    ring's spectrum; each carrier its whole amplitude, within the band's
    edge and clear of every station."""
    geo, spec = small_geo(), quiet_spec()
    lay = band.layout(geo, spec, torch.Generator().manual_seed(seed))
    x = band.make_ring(geo, spec, torch.Generator().manual_seed(seed),
                       0.0)[:, 0]
    length = len(x)
    fs = geo.timf1_sampling_speed
    spectrum = np.fft.fft(x.astype(np.complex128)) / length
    k = spec["stations"]
    hz = lay["station_hz"]
    assert len(hz) == k and len(lay["carrier_hz"]) == spec["carriers"]
    slot = np.floor((hz - spec["band_lo_hz"]) / spec["slot_hz"])
    np.testing.assert_array_equal(slot, np.arange(k))
    centre = spec["band_lo_hz"] + spec["slot_hz"] * (np.arange(k) + 0.5)
    bin_hz = fs / geo.fftx_size
    assert np.all(np.abs(hz - centre) <= spec["offset_max_hz"] + bin_hz / 2)
    np.testing.assert_allclose(hz / bin_hz, np.round(hz / bin_hz))
    assert np.all((spec["amplitude_lo"] <= lay["station_amp"])
                  & (lay["station_amp"] <= spec["amplitude_hi"]))
    on = spec["key_on_elements"] / 4
    cycles = np.round(hz * length / fs).astype(int) % length
    np.testing.assert_allclose(np.abs(spectrum[cycles]),
                               on * lay["station_amp"], rtol=2e-3)
    chz = lay["carrier_hz"]
    assert np.all(np.abs(chz) <= spec["carrier_edge_hz"] + fs / length)
    assert np.abs(chz[:, None] - hz[None, :]).min() >= \
        spec["carrier_clear_hz"] - fs / length
    assert np.all((spec["carrier_lo"] <= lay["carrier_amp"])
                  & (lay["carrier_amp"] <= spec["carrier_hi"]))
    cycles = np.round(chz * length / fs).astype(int) % length
    np.testing.assert_allclose(np.abs(spectrum[cycles]), lay["carrier_amp"],
                               rtol=1e-3)
    # nothing else of that strength in the band
    rest = np.abs(spectrum).copy()
    rest[cycles] = 0
    assert rest.max() < 0.6 * spec["amplitude_hi"]


def test_the_entry_tunes_the_generators_stations():
    from rxbench.entries import multi
    run = core.Run({}, CONFIG, TRAFFIC, SEED, 1.0, False, "cpu", dict(SIZE))
    hz = multi.tunings(run, small_geo())
    gen = core.torch_generator(SEED, "cpu", 1, 0)
    np.testing.assert_array_equal(
        hz, band.layout(small_geo(), run.ring_spec(), gen)["station_hz"])
    assert len(hz) == CONFIG["sub_receivers"] == 24


def test_the_cell_runs_at_the_small_cut(monkeypatch):
    from rxbench.entries import multi as entry
    slices = []
    real = entry.Session.trace_slice
    monkeypatch.setattr(entry.Session, "trace_slice",
                        lambda self: slices.append(real(self)) or slices[-1])
    result, lines, err = run_small(trace=True)
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0
    assert "band_h2d_ms_per_block" in result["metrics"]
    assert set(result["checks"]) == set(core.load_json(
        core.BENCH_DIR / "limits" / f"{CELL}.json"))
    assert any("24 sub-receivers" in line for line in lines)
    (traced,) = slices
    n = TRAFFIC["trace_blocks"]
    assert f"subrx_blocks {24 * n} in {n} blocks" in traced.notes
    geo = small_geo()
    assert traced.shapes["update"] == (1, geo.fft1_size)
    traced.ops += [("sellim_front_kernel", 1e-3), ("sellim_back_kernel",
                                                   1e-3)]
    share = core.load_metric("update_roofline_share").read(traced)
    assert share == pytest.approx(
        100 * 20 * geo.fft1_size / 3.35e12 / 2e-3)
    e2e, _lines, _err = run_small()
    assert sorted(e2e["metrics"]) == ["msamples_per_s", "setup_s"]


def test_frames_count_the_stream_once_a_block():
    from rxbench.entries import multi
    geo = small_geo()
    run = core.Run({}, CONFIG, TRAFFIC, SEED, 0.3, False, "cpu", dict(SIZE))
    session = multi.Session(run)
    win = session.window(0.2, [])
    assert win["frames"] == win["stream_steps"] * geo.samples_per_step


def test_lower_precision_fails():
    result, _lines, err = run_small(program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err


def stale_sub_receivers(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)

        def stale(tables, state, nbs, block, tune_bins):
            (new, _nbs), out = step(tables, state, nbs, block, tune_bins)
            return (new, nbs), out
        return stale
    return make


def test_a_stale_sub_receiver_state_is_not_correct(monkeypatch):
    from linrad_tpu_torch.pipeline import receiver as mod
    monkeypatch.setattr(mod, "make_multi_rx_step",
                        stale_sub_receivers(mod.make_multi_rx_step))
    result, _lines, err = run_small()
    assert not result["correct"], err
    assert result["checks"]["audio"]["value"] > \
        result["checks"]["audio"]["limit"]


def test_one_sub_receiver_a_bin_off_is_not_correct(monkeypatch):
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    real = MultiReceiver.tune_subch

    def off(self, k, freq_hz):
        real(self, k, freq_hz)
        if k == 5:
            self._tune_bins[k] += 1

    monkeypatch.setattr(MultiReceiver, "tune_subch", off)
    result, _lines, err = run_small()
    assert not result["correct"], err
    assert result["checks"]["audio"]["value"] > \
        result["checks"]["audio"]["limit"]


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_read_none_without_spans_or_kernels(metric, monkeypatch):
    import rxbench.program_spans as spans
    monkeypatch.setattr(spans, "totals", lambda: {})
    traced = tracing.Traced(ops=[("some_other_kernel", 1e-3)],
                            stream_steps=4)
    assert core.load_metric(metric).read(traced) is None


@pytest.mark.parametrize("metric", METRICS[:2])
def test_span_metrics_read_the_ports_spans(metric, monkeypatch):
    import rxbench.program_spans as spans
    name = {"band_h2d_ms_per_block": "multi.h2d",
            "band_owned_ms_per_block": "multi.owned"}[metric]
    monkeypatch.setattr(spans, "totals", lambda: {
        "multi.block": {"count": 4, "seconds": 0.04},
        name: {"count": 4, "seconds": 0.008}})
    assert core.load_metric(metric).read(tracing.Traced()) == \
        pytest.approx(2.0)


@pytest.mark.card
def test_cell_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED, 2.0, True, card,
                                        time.perf_counter())
    assert result["correct"], err
    assert result["device"]["platform"] == "gpu"
    assert set(METRICS) <= set(result["metrics"])
    assert result["metrics"]["update_roofline_share"]["value"] <= 100


@pytest.mark.card
def test_control_fails_on_the_card(card):
    result, _lines, err = core.run_cell(CELL, SEED + 1, 1.0, False, card,
                                        time.perf_counter(),
                                        program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err
