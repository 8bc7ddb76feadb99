"""The port's ``MultiReceiver`` against the benchmark's plain reference
(``rxbench/reference/multi.py``: ``PlainMultiReceiver`` over the frozen
``make_multi_rx_step``), on device="cpu" at a small cut of the band
station's configuration (``rxbench/configs/ssb-multi24-2msps.json``: fft1
256, 2,048 samples a step, ``fft1_variant`` None) with K = 3 sub-receivers
on the first three stations of the cell's own traffic
(``rxbench/generators/band.py``), eagerly and with the graph's body run
eagerly (``graphed=True``), step by step.

The bars are the port's (ROADMAP, "Rules of the port"): audio 2.3e-4,
fft2_power 1e-6, liminfo's signs exact and its gains 1e-5, the integer
fields exact, every other float field 1e-4, each relative to the field's
largest magnitude in the step (sub-receiver by sub-receiver for the
narrowband fields).  Then the ``multi.*`` spans and the ``subrx_blocks``
counter under ``trace.enable()``, and the configuration's geometry at its
full size through the port's ``derive_geometry`` and the reference's.
No JAX is imported."""

import json

import numpy as np
import pytest
import torch

from linrad_tpu_torch.geometry import derive_geometry
from linrad_tpu_torch.params import RxParams
from linrad_tpu_torch.pipeline.receiver import MultiReceiver
from linrad_tpu_torch.utils import trace
from rxbench import core
from rxbench.generators import band
from rxbench.reference import geometry as ref_geometry
from rxbench.reference.multi import PlainMultiReceiver
from rxbench.reference.receiver import make_params

CONFIG = core.load_json(core.BENCH_DIR / "configs" / "ssb-multi24-2msps.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "band.json")
SMALL = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
             max_pulses_per_block=8)
K = 3
STEPS = 6
SEED = 23
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER = 1e-4
INTEGER = ("blanker_fitted", "blanker_cleared")


def fields() -> dict:
    return {**CONFIG["params"], **SMALL}


def ring_and_tuning(seed: int = SEED):
    """The cell's ring at the small cut, as blocks, and the first K
    stations' frequencies."""
    geo = ref_geometry.derive_geometry(make_params(fields()))
    spec = {**TRAFFIC["ring"], "steps": STEPS}
    x = band.make_ring(geo, spec, torch.Generator().manual_seed(seed), 0.0)
    hz = band.sub_receiver_hz(geo, spec, torch.Generator().manual_seed(seed))
    s = geo.samples_per_step
    return [x[i * s:(i + 1) * s] for i in range(STEPS)], hz[:K]


def port(graphed: bool, hz) -> MultiReceiver:
    rx = MultiReceiver(RxParams.from_json(json.dumps(fields()), strict=True),
                       K, device="cpu", graphed=graphed)
    for k, f in enumerate(hz):
        rx.tune_subch(k, float(f))
    return rx


def reference(hz) -> PlainMultiReceiver:
    ref = PlainMultiReceiver(make_params(fields()), K, "cpu")
    for k, f in enumerate(hz):
        ref.tune_subch(k, float(f))
    return ref


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item()
    return gap / scale if scale > 0 else gap


@pytest.fixture(scope="module", params=[False, True],
                ids=["eager", "graph-body"])
def runs(request):
    """Every step's outputs of the port and of the reference, and both
    final states."""
    blocks, hz = ring_and_tuning()
    rx, ref = port(request.param, hz), reference(hz)
    got, want = [], []
    for b in blocks:
        got.append(rx.process_block(b))
        want.append(ref.process_block(torch.from_numpy(b)))
    return got, want, rx, ref


@pytest.mark.parametrize("field", ["audio", "baseb", "agc_gain"])
def test_narrowband_fields_per_sub_receiver(runs, field):
    got, want, _rx, _ref = runs
    bar = BARS.get(field, OTHER)
    for step, (g, w) in enumerate(zip(got, want)):
        a, b = getattr(g, field), getattr(w, field)
        assert a.shape == b.shape and a.shape[0] == K
        for k in range(K):
            assert rel(a[k], b[k]) <= bar, (field, step, k)


@pytest.mark.parametrize("field", ["fft1_power", "fft1_avg_power",
                                   "fft2_power", "liminfo", "noise_floor"])
def test_wideband_fields(runs, field):
    got, want, _rx, _ref = runs
    bar = BARS.get(field, OTHER)
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel(getattr(g, field), getattr(w, field)) <= bar, (field,
                                                                    step)


def test_liminfo_signs_and_integer_fields_exact(runs):
    got, want, _rx, _ref = runs
    for g, w in zip(got, want):
        assert torch.equal(torch.sign(g.liminfo), torch.sign(w.liminfo))
        for f in INTEGER:
            assert int(getattr(g, f)) == int(getattr(w, f)), f


def test_final_states(runs):
    from rxbench.reference.receiver import tensor_leaves
    _got, _want, rx, ref = runs
    for mine, theirs in ((rx.state, ref.state), (rx.nbs, ref.nbs)):
        a, b = tensor_leaves(mine), tensor_leaves(theirs)
        assert [(t.shape, t.dtype) for t in a] == \
            [(t.shape, t.dtype) for t in b]
        for x, y in zip(a, b):
            if x.dtype.is_floating_point or x.dtype.is_complex:
                assert rel(x, y) <= OTHER
            else:
                assert torch.equal(x, y)


def test_comparison_is_not_vacuous(runs):
    """The sub-receivers hear their own stations, the blankers work and
    sellim limits the band's carriers: the bars compare something."""
    got, _want, _rx, _ref = runs
    audio = torch.stack([g.audio for g in got])
    peaks = audio.abs().amax(dim=(0, 2, 3))
    assert peaks.shape == (K,) and bool((peaks > 0).all())
    assert not torch.equal(got[-1].audio[0], got[-1].audio[1])
    assert sum(int(g.blanker_cleared) + int(g.blanker_fitted)
               for g in got) > 0
    assert bool((got[-1].liminfo != 0).any())


def test_a_sub_receiver_one_bin_off_fails_the_bar():
    blocks, hz = ring_and_tuning()
    rx, ref = port(False, hz), reference(hz)
    rx._tune_bins[1] += 1
    gaps = []
    for b in blocks:
        g = rx.process_block(b)
        w = ref.process_block(torch.from_numpy(b))
        gaps.append(rel(g.audio[1], w.audio[1]))
        assert rel(g.audio[0], w.audio[0]) <= BARS["audio"]
    assert max(gaps) > 100 * BARS["audio"]


@pytest.mark.parametrize("graphed", [False, True],
                         ids=["eager", "graph-body"])
def test_spans_and_counter(graphed):
    blocks, hz = ring_and_tuning()
    rx = port(graphed, hz)
    was = trace._enabled
    trace.reset()
    trace.enable()
    try:
        for b in blocks[:3]:
            rx.process_block(b)
        rep = trace.report()
        recs = trace.records()
    finally:
        if not was:
            trace.disable()
    assert rep["counters"]["subrx_blocks"] == 3 * K
    assert rep["counters"]["h2d_bytes"] == 3 * blocks[0].nbytes
    assert rep["blocks"] == 3
    inner = "multi.replay" if graphed else "multi.step"
    want = {("multi.block", None), ("multi.h2d", "multi.block"),
            (inner, "multi.block")}
    if graphed:
        want.add(("multi.owned", "multi.block"))
    assert {(r[0], r[1]) for r in recs if r[0].startswith("multi.")} == want
    assert not any(r[0].startswith("rx.") for r in recs)
    assert rep["spans"]["multi.block"]["count"] == 3
    assert rep["ms_per_block"]["multi.h2d"] >= 0


def test_outputs_bit_identical_with_tracing_on_and_off():
    blocks, hz = ring_and_tuning()
    outs = []
    was = trace._enabled
    try:
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            rx = port(True, hz)
            outs.append([rx.process_block(b) for b in blocks[:3]])
    finally:
        (trace.enable if was else trace.disable)()
    for a, b in zip(*outs):
        for f in ("audio", "baseb", "fft2_power", "liminfo"):
            assert torch.equal(getattr(a, f), getattr(b, f))


def test_config_geometry_at_full_size():
    """The configuration's params give fft1 32,768 (Linrad's cap with the
    second FFT on), fft2 65,536, mix1 256 and 1,048,576 samples a step
    through the port's geometry and the reference's alike."""
    fields_ = dict(CONFIG["params"])
    port_geo = derive_geometry(RxParams.from_json(json.dumps(fields_),
                                                  strict=True))
    ref_geo = ref_geometry.derive_geometry(make_params(fields_))
    for geo in (port_geo, ref_geo):
        assert (geo.fft1_size, geo.fft2_size, geo.mix1_size) == (
            32768, 65536, 256)
        assert geo.samples_per_step == 1 << 20
        assert (geo.fft1_frames_per_step, geo.fft2_frames_per_step,
                geo.fft3_frames_per_step) == (64, 32, 16)
        assert geo.baseband_sampling_speed == 7812.5
    assert port_geo.__dict__ == ref_geo.__dict__
    assert CONFIG["sub_receivers"] == 24 and "sub_receivers" not in fields_
    assert CONFIG["params"]["fft1_variant"] is None


def test_stations_on_fftx_bins_of_the_full_size():
    """At full size the band's 24 stations sit on fftx bins (30.5 Hz), one
    in each 75 kHz slot, where MultiReceiver.tune_subch puts its
    sub-receivers."""
    geo = ref_geometry.derive_geometry(make_params(CONFIG["params"]))
    spec = TRAFFIC["ring"]
    hz = band.sub_receiver_hz(geo, spec, torch.Generator().manual_seed(5))
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    assert len(hz) == 24
    np.testing.assert_allclose(hz / bin_hz, np.round(hz / bin_hz), atol=1e-9)
    slot = np.floor((hz - spec["band_lo_hz"]) / spec["slot_hz"])
    np.testing.assert_array_equal(slot, np.arange(24))
