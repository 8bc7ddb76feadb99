"""The slice: the flagship receive step through the port's Receiver
against the JAX package's Receiver, at _flagship_params(tiny=True)
(fft1 256, fft2 512, 1,024 samples per step), 6 steps, from the same
tables and state carried across by linrad_tpu_torch.convert.

The JAX side runs jitted on the CPU; with fft1_variant="pallas" its
Pallas kernel runs in interpret mode, as tests/test_pallas.py runs it.
The port's "pallas" path on the CPU is its kernel's plain version.

Bars, per RxOutputs field (max_rel = max|a-b| / max(max|a|, max|b|) over
all steps, as tools/tpu_parity.py measures it):
- liminfo sign pattern (zero / negative / positive per bin),
  blanker_fitted and blanker_cleared: exact; liminfo values <= 1e-5;
- audio <= 2.3e-4 (the TPU-vs-CPU gate of TPU_PARITY.json);
- fft2_power <= 1e-6;
- every other float field (noise_floor included) <= 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import Demod, InputMode
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu_torch import convert
from linrad_tpu_torch.pipeline.chain import make_rx_step
from linrad_tpu_torch.pipeline.receiver import Receiver

STEPS = 6
TUNE_HZ = 12_345.6
FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER_BAR = 1e-4

_TINY = _flagship_params(tiny=True)
CONFIGS = {
    "pallas": dataclasses.replace(_TINY, fft1_variant="pallas"),
    "xla": dataclasses.replace(_TINY, fft1_variant="xla"),
    # flat clever blanker + AGC hang (sliding_max) on the same slice
    "flat-hang": dataclasses.replace(_TINY, fft1_variant="xla",
                                     blanker_block_size=0, agc_hang_ms=5.0),
    # fft1 feeds mix1 directly
    "no-fft2": dataclasses.replace(_TINY, second_fft_enable=False,
                                   blanker_enable=False),
}


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _input(geo) -> np.ndarray:
    """Gaussian noise, a carrier strong enough for liminfo strong bins,
    a weak tone at the dial, and 12 impulses per step (more than the 8
    pulses the tiny geometry fits, so both blankers work)."""
    rng = np.random.default_rng(1)
    n = STEPS * geo.samples_per_step
    t = np.arange(n) / geo.timf1_sampling_speed
    x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         + 100.0 * np.exp(2j * np.pi * -20_000.0 * t)
         + 2.0 * np.exp(2j * np.pi * TUNE_HZ * t))
    for s in range(STEPS):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=12))
    return x.astype(np.complex64)[:, None]


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    """Both receivers over the same input from the same tables/state; the
    JAX step is jitted once here."""
    p = CONFIGS[request.param]
    jrx = JaxReceiver(p)
    trx = Receiver(p, device="cpu")
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    iq = _input(jrx.geo)
    j_out = list(jrx.run(iq))
    t_out = list(trx.run(iq))
    assert len(j_out) == len(t_out) == STEPS
    return request.param, p, jrx, trx, j_out, t_out


@pytest.mark.parametrize("field", FIELDS)
def test_field_parity(runs, field):
    name, p, _jrx, _trx, j_out, t_out = runs
    jv = [getattr(o, field) for o in j_out]
    tv = [getattr(o, field) for o in t_out]
    if not p.second_fft_enable and field in ("fft2_power", "liminfo",
                                             "blanker_fitted",
                                             "blanker_cleared",
                                             "noise_floor"):
        assert all(v is None for v in jv + tv)
        return
    for a, b in zip(tv, jv):
        assert tuple(a.shape) == tuple(np.shape(b)), field
    if field in ("blanker_fitted", "blanker_cleared"):
        assert [int(v) for v in tv] == [int(v) for v in jv]
        return
    t_arr = np.stack([v.numpy() for v in tv])
    j_arr = np.stack([np.asarray(v) for v in jv])
    if field == "liminfo":
        np.testing.assert_array_equal(np.sign(t_arr), np.sign(j_arr))
    assert _max_rel(t_arr, j_arr) <= BARS.get(field, OTHER_BAR), name


def test_comparison_not_vacuous(runs):
    name, p, _jrx, _trx, j_out, t_out = runs
    assert max(float(np.abs(np.asarray(o.audio)).max()) for o in j_out) > 0
    if not p.second_fft_enable:
        return
    assert max(int(o.blanker_fitted) for o in j_out) > 0
    assert max(int(o.blanker_cleared) for o in j_out) > 0
    assert max(int((np.asarray(o.liminfo) != 0).sum()) for o in j_out) > 0
    assert any((np.asarray(o.liminfo) > 0).any() for o in j_out)


def test_final_state(runs):
    """The carried state after 6 steps: integers exact, floats <= 1e-4."""
    _name, _p, jrx, trx, _j, _t = runs
    ref = convert.flatten(jrx.state)
    port = convert.state_to_numpy(trx.state)
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= OTHER_BAR, k


def test_make_rx_step_matches_receiver():
    """make_rx_step called directly gives the Receiver's first step."""
    p = CONFIGS["pallas"]
    rx = Receiver(p, device="cpu")
    rx.tune(TUNE_HZ)
    block = _input(rx.geo)[: rx.geo.samples_per_step]
    state0, tables = rx.state, rx.tables
    out = rx.process_block(block)
    step = make_rx_step(rx.geo, p, blanker_pulsewidth=rx.blanker_pulsewidth,
                        fractional_tune=True)
    _state, out2 = step(tables, state0, torch.from_numpy(block),
                        rx._tune_bin, rx._tune_frac)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(out2, f)), f
    assert abs(rx.tuned_hz - TUNE_HZ) < 1e-3


def test_receiver_rejects_bad_block():
    rx = Receiver(CONFIGS["xla"], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        rx.process_block(np.zeros((rx.geo.samples_per_step - 1, 1),
                                  np.complex64))


def test_cuda_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(CONFIGS["pallas"], device="cuda")


REFUSED_PARAMS = {
    "real-input": dict(input_mode=InputMode.REAL),
    "two-channel": dict(rx_rf_channels=2),
    "demod-am": dict(demod=Demod.AM),
    "demod-fm": dict(demod=Demod.FM),
    "demod-coherent": dict(demod=Demod.COHERENT),
    "demod-none": dict(demod=Demod.NONE),
    "mixer-mode-2": dict(mixer_mode=2),
    "squelch": dict(squelch_enable=True),
    "expander": dict(expander_exponent=2.0),
    "blanker-rounds": dict(blanker_rounds=2),
    "mxu": dict(fft1_variant="mxu"),
    "mxu-bf16": dict(fft1_variant="mxu_bf16"),
    "afc": dict(afc_enable=True),
    "spur": dict(spur_enable=True),
    "pol-adapt": dict(pol_adapt_enable=True),
    "shards": dict(shards=2),
}


@pytest.mark.parametrize("name", list(REFUSED_PARAMS))
def test_refused_configuration(name):
    p = dataclasses.replace(_TINY, **REFUSED_PARAMS[name])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Receiver(p, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_rx_step(None, p)


@pytest.mark.parametrize("name", ["audio_out_rate", "iq_corr", "transport",
                                  "pace", "watchdog", "monitor", "hook",
                                  "tune_slope"])
def test_refused_host_feature(name):
    p = CONFIGS["xla"]
    if name == "audio_out_rate":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Receiver(p, device="cpu", audio_out_rate=8000.0)
        return
    if name == "iq_corr":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Receiver(p, device="cpu", calibration={
                "iq_corr": np.zeros(256, np.complex64)})
        return
    rx = Receiver(p, device="cpu")
    iq = np.zeros((rx.geo.samples_per_step, 1), np.complex64)
    if name == "hook":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rx.add_hook("block", lambda *a: None)
    elif name == "tune_slope":
        step = make_rx_step(rx.geo, p, rx.blanker_pulsewidth, True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step(rx.tables, rx.state, torch.from_numpy(iq), rx._tune_bin,
                 rx._tune_frac, torch.zeros(()))
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            next(rx.run(iq, **{name: object()}))
