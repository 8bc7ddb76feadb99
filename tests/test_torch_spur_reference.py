"""The port's spur canceller and AFC against the benchmark's plain
reference (``rxbench/reference/receiver.py``: ``PlainReceiver`` over the
frozen chain, ``weak/spur.py`` and ``weak/afc.py``), on device="cpu" at a
small cut of the QRSS grabber's configuration
(``rxbench/configs/qrss-96k-spur.json``: fft1 256, fft2 2,048, 8 fft2
frames and 8,192 samples a step), eagerly and with the graph's body run
eagerly (``graphed=True``), step by step over 10 steps.

At this cut a step is 85 ms of signal, so ``control.spur_scan_interval``
is set to 1 on both sides (the configuration's own step of 5.46 s gives
1 too) and the managers' ``drop_after`` to 3.  The input: a keyed tone
the AFC locks on, a steady birdie, a birdie that drifts across more than
a bin (a re-centre) and one that stops after the third step (a drop),
complex noise.  Compared after every step: every output field to the
port's bars (ROADMAP, "Rules of the port"), the AFC's status exactly and
its tuning to 1e-6 bins, the spur slots' bins and ages exactly and their
amplitude, rotation and offset to 1e-5.  Then the configuration's
geometry at its full size, and the cell's own generator.

The tests marked ``card`` need a CUDA device (they skip here): the
configuration at its full size, the graphed receiver bit-equal to the
eager one with tracing off and on, over 6 blocks of the cell's traffic
whose scans add slots, and ``step.spur``'s device time.  This file
imports no JAX and needs nothing of ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_spur_reference.py -m
card`` runs them on the card."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from linrad_tpu_torch.geometry import derive_geometry
from linrad_tpu_torch.params import RxParams
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.utils import trace
from rxbench import core
from rxbench.generators import qrss_band
from rxbench.reference import geometry as ref_geometry
from rxbench.reference.receiver import PlainReceiver, make_params

CONFIG = core.load_json(core.BENCH_DIR / "configs" / "qrss-96k-spur.json")
TRAFFIC = core.load_json(core.BENCH_DIR / "traffic" / "grabber.json")
SMALL = dict(fft1_n_override=8, target_fft1_frames_per_step=64, fft3_n=6,
             max_pulses_per_block=8)
STEPS = 10
DIAL_HZ = TRAFFIC["dial_hz"]
DROP_AFTER = 3
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER = 1e-4
SPUR_BAR = 1e-5
STEADY_HZ = -7_030.0
DRIFT_HZ = 12_010.0
DRIFT_RATE = 80.0          # Hz/s: 68 Hz, 1.45 bins of 46.9 Hz, in 10 steps
STOPS_HZ = 20_480.0
STOPS_AFTER = 3


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def fields() -> dict:
    return {**CONFIG["params"], **SMALL}


def small_input(seed: int = 41) -> list:
    """STEPS blocks: the tone 10 Hz above the dial keyed in 20 ms elements,
    the three birdies, noise of sigma 1."""
    geo = ref_geometry.derive_geometry(make_params(fields()))
    s = geo.samples_per_step
    fs = geo.timf1_sampling_speed
    rng = np.random.default_rng(seed)
    t = np.arange(STEPS * s) / fs
    key = (np.floor(t / 0.02) % 4 < 3).astype(np.float64)
    x = 0.5 * key * np.exp(2j * np.pi * (DIAL_HZ + 10.0) * t)
    x = x + 1.2 * np.exp(2j * np.pi * STEADY_HZ * t + 0.4j)
    x = x + 0.9 * np.exp(2j * np.pi * (DRIFT_HZ * t
                                       + 0.5 * DRIFT_RATE * t ** 2) + 1.3j)
    x = x + 1.5 * (t < STOPS_AFTER * s / fs) * np.exp(
        2j * np.pi * STOPS_HZ * t + 2.2j)
    x = x + rng.normal(size=t.size) + 1j * rng.normal(size=t.size)
    x = x.astype(np.complex64)[:, None]
    return [x[i * s:(i + 1) * s] for i in range(STEPS)]


def every_step(control) -> None:
    control.spur_scan_interval = 1
    control.spur_manager.drop_after = DROP_AFTER


def port(graphed: bool) -> Receiver:
    rx = Receiver(RxParams.from_json(json.dumps(fields()), strict=True),
                  device="cpu", graphed=graphed)
    every_step(rx.control)
    rx.tune(DIAL_HZ)
    return rx


def reference() -> PlainReceiver:
    ref = PlainReceiver(make_params(fields()), "cpu")
    every_step(ref.control)
    ref.tune(DIAL_HZ)
    return ref


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item()
    return gap / scale if scale > 0 else gap


def spur_now(spur, manager) -> dict:
    out = {f: getattr(spur, f).clone() for f in ("bins", "amp", "rot",
                                                 "frac")}
    out["age"] = dict(manager._age)
    return out


def tuning(t: tuple) -> tuple:
    return tuple(None if x is None else x.clone() for x in t)


@pytest.fixture(scope="module", params=[False, True],
                ids=["eager", "graph-body"])
def runs(request):
    """After every step: the outputs, the AFC's status and tuning and the
    spur slots, of the port and of the reference."""
    rx, ref = port(request.param), reference()
    got, want = [], []
    for b in small_input():
        out = rx.process_block(b)
        got.append((out, rx.afc.status, tuning((rx._tune_bin,
                                                rx._tune_frac,
                                                rx._tune_slope)),
                    spur_now(rx.state.spur, rx.spur_manager)))
        w = ref.process_block(torch.from_numpy(b))
        want.append((w, ref.control.afc.status,
                     tuning((ref.tune_bin, ref.tune_frac, ref.tune_slope)),
                     spur_now(ref.state.spur, ref.control.spur_manager)))
    return got, want


@pytest.mark.parametrize("field", ["audio", "baseb", "agc_gain",
                                   "fft1_power", "fft1_avg_power",
                                   "fft2_power", "liminfo", "noise_floor"])
def test_output_fields(runs, field):
    got, want = runs
    bar = BARS.get(field, OTHER)
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel(getattr(g[0], field), getattr(w[0], field)) <= bar, step


def test_afc_status_and_tuning(runs):
    got, want = runs
    n = ref_geometry.derive_geometry(make_params(fields())).fftx_size
    for step, (g, w) in enumerate(zip(got, want)):
        assert g[1] == w[1], step
        for a, b in zip(g[2], w[2]):
            assert (a is None) == (b is None), step
        db = (g[2][0] - w[2][0] + n // 2) % n - n // 2
        assert float((db + g[2][1] - w[2][1]).abs().max()) <= 1e-6, step
        if g[2][2] is not None:
            assert float((g[2][2] - w[2][2]).abs().max()) <= 1e-6, step
    assert [g[1] for g in got][-1] == 3


def test_spur_slots_exact_and_models_close(runs):
    got, want = runs
    for step, (g, w) in enumerate(zip(got, want)):
        gs, ws = g[3], w[3]
        assert torch.equal(gs["bins"], ws["bins"]), step
        assert gs["age"] == ws["age"], step
        active = ws["bins"] >= 0
        for f in ("amp", "rot", "frac"):
            assert rel(gs[f][active], ws[f][active]) <= SPUR_BAR, (f, step)


def test_the_manager_adds_recentres_and_drops(runs):
    """The comparison is not vacuous: the birdies take slots at the first
    scan, the drifting one moves its bin, the one that stopped is dropped
    after the grace scans, and the tone at the dial takes none."""
    got, _want = runs
    geo = ref_geometry.derive_geometry(make_params(fields()))
    n, fs = geo.fftx_size, geo.timf1_sampling_speed

    def bins_of(step):
        return {int(b) for b in got[step][3]["bins"] if b >= 0}

    def bin_of(hz):
        return int(round(hz / fs * n)) % n

    first = bins_of(0)
    assert {bin_of(STEADY_HZ), bin_of(DRIFT_HZ), bin_of(STOPS_HZ)} <= first
    assert bin_of(DIAL_HZ) not in bins_of(STEPS - 1)
    drifted = [b for b in bins_of(STEPS - 1)
               if 0 < b - bin_of(DRIFT_HZ) <= 3]
    assert drifted and bin_of(DRIFT_HZ) not in bins_of(STEPS - 1)
    assert bin_of(STOPS_HZ) not in bins_of(STEPS - 1)
    assert bin_of(STEADY_HZ) in bins_of(STEPS - 1)


def test_counters_and_slots_follow_the_manager():
    rx = port(True)
    blocks = small_input()
    trace.reset()
    try:
        for b in blocks:
            rx.process_block(b)
        rep = trace.report()
    finally:
        trace.reset()
    c = rep["counters"]
    held = int((rx.state.spur.bins >= 0).sum())
    assert rx.control.spur_slots == held
    assert c["spur_slots"] >= held          # summed over live receivers
    assert c["spur_scans"] == STEPS
    assert c["spur_adds"] - c["spur_drops"] == held
    assert c["spur_adds"] >= 3 and c["spur_drops"] >= 1
    assert c["spur_shifts"] >= 1


def test_config_geometry_at_full_size():
    """preset(RxMode.QRSS, rx_ad_speed=96000, spur_enable=True) written out:
    fft1 16,384, fft2 131,072, mix1 4,096, 524,288 samples and 8 fft2
    frames a step, through the port's geometry and the reference's."""
    from linrad_tpu_torch import RxMode, preset
    p = preset(RxMode.QRSS, rx_ad_speed=96_000, spur_enable=True)
    want = json.loads(p.to_json())
    want.pop("check")
    assert CONFIG["params"] == want
    port_geo = derive_geometry(RxParams.from_json(
        json.dumps(CONFIG["params"]), strict=True))
    ref_geo = ref_geometry.derive_geometry(make_params(CONFIG["params"]))
    assert port_geo.__dict__ == ref_geo.__dict__
    assert (port_geo.fft1_size, port_geo.fft2_size, port_geo.mix1_size) == (
        16384, 131072, 4096)
    assert port_geo.samples_per_step == 524288
    assert port_geo.fftx_frames_per_step == 8
    step_s = port_geo.samples_per_step / port_geo.timf1_sampling_speed
    assert max(1, int(round(1.4 / step_s))) == 1


def test_the_cells_layout_at_full_size():
    """The grabber's layout as the traffic gives it: the target 2 Hz over
    the dial within the control's protected +-7 bins through its drift,
    the other beacons 12-90 Hz up and 10 Hz apart, the near birdies
    300-1,400 Hz from the dial (outside the AFC's 200 Hz search), the far
    ones within 45 kHz, one birdie drifting."""
    geo = ref_geometry.derive_geometry(make_params(CONFIG["params"]))
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    spec = TRAFFIC["ring"]
    for seed in (1, (1 << 31) + 7):
        lay = qrss_band.layout(geo, spec, torch.Generator().manual_seed(seed),
                               DIAL_HZ)
        kind = np.array(lay["kind"])
        off = np.array(lay["hz"]) - DIAL_HZ
        drift = np.array(lay["drift_hz"])
        assert list(kind) == ["target"] + ["beacon"] * 3 + ["birdie"] * 6
        assert (abs(off[0]) + drift[0]) / bin_hz < 7
        beacons = off[kind == "beacon"]
        assert np.all((12 <= beacons) & (beacons <= 90))
        assert np.abs(np.diff(np.sort(off[kind != "birdie"]))).min() >= 10
        birdies = off[kind == "birdie"]
        assert np.all((300 <= np.abs(birdies[:3]))
                      & (np.abs(birdies[:3]) <= 1400))
        far = np.array(lay["hz"])[kind == "birdie"][3:]
        assert np.all((np.abs(far) <= 45_000) & (np.abs(birdies[3:]) > 1500))
        assert np.count_nonzero(drift[kind == "birdie"]) == 1
        amp = np.array(lay["amp"])
        assert np.all((0.05 <= amp[kind == "birdie"])
                      & (amp[kind == "birdie"] <= 0.3))
        assert np.all((0.004 <= amp[kind == "beacon"])
                      & (amp[kind == "beacon"] <= 0.008))


# ---- on the card ----------------------------------------------------------

CARD_BLOCKS = 6


def card_blocks(device) -> list:
    """The first blocks of a ring of the cell's traffic at full size."""
    geo = ref_geometry.derive_geometry(make_params(CONFIG["params"]))
    spec = {**TRAFFIC["ring"], "steps": CARD_BLOCKS}
    gen = torch.Generator(device=device).manual_seed(25)
    x = qrss_band.make_ring(geo, spec, gen, DIAL_HZ)
    s = geo.samples_per_step
    return [x[i * s:(i + 1) * s] for i in range(CARD_BLOCKS)]


def card_run(device, graphed: bool, blocks: list) -> list:
    rx = Receiver(RxParams.from_json(json.dumps(CONFIG["params"]),
                                     strict=True),
                  device=device, graphed=graphed)
    rx.tune(DIAL_HZ)
    steps = []
    for b in blocks:
        out = rx.process_block(b)
        steps.append(({f.name: None if getattr(out, f.name) is None
                       else getattr(out, f.name).clone()
                       for f in dataclasses.fields(out)},
                      rx.afc.status,
                      spur_now(rx.state.spur, rx.spur_manager)))
    return steps, rx


@pytest.mark.card
@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_card_graphed_equals_eager_at_full_size(card, tracing):
    """6 blocks of the grabber's traffic through the graphed and the eager
    Receiver at full size: every output field, the AFC's status and the
    spur slots equal bit for bit, the first scan adding slots; with
    tracing on the graphs' stage-timed twins, which the graphed receiver
    replays then, carry ``step.spur``'s events."""
    blocks = card_blocks(card)
    trace.disable()
    trace.reset()
    try:
        if tracing:
            trace.enable()
        eager, _ = card_run(card, False, blocks)
        graphed, rx = card_run(card, True, blocks)
        torch.cuda.synchronize()
        rep = trace.report()
    finally:
        trace.disable()
        trace.reset()
    assert rx.graphs
    for step, (a, b) in enumerate(zip(eager, graphed)):
        for name, x in a[0].items():
            y = b[0][name]
            assert (x is None) == (y is None), (name, step)
            if x is not None:
                assert torch.equal(x, y), (name, step)
        assert a[1] == b[1], step
        for f in ("bins", "amp", "rot", "frac"):
            assert torch.equal(a[2][f], b[2][f]), (f, step)
        assert a[2]["age"] == b[2]["age"], step
    assert int((graphed[0][2]["bins"] >= 0).sum()) > 0
    if tracing:
        names = [n for g in rx.graphs.values()
                 for n in (g.timed_stages or [])]
        assert "step.spur" in names
        assert rep["stage_ms"]["step.spur"] > 0
        print(f"card: step.spur {rep['stage_ms']['step.spur']:.4f} ms a "
              f"replay over {rep['stage_replays']} replays; stages "
              f"{json.dumps(rep['stage_ms'])}")
