"""The slice: the flagship receive step through the port's Receiver
against the JAX package's Receiver, at _flagship_params(tiny=True)
(fft1 256, fft2 512, 1,024 samples per step), 6 steps, from the same
tables and state carried across by linrad_tpu_torch.convert.

The JAX side runs jitted on the CPU; with fft1_variant="pallas" its
Pallas kernel runs in interpret mode, as tests/test_pallas.py runs it.
The port's "pallas" path on the CPU is its kernel's plain version.  The
"filtercorr-*" configurations hand both receivers the same calibration
dict (a filtercorr from calibration.make_filtercorr on a non-flat
response), the port's positionally, as the JAX Receiver takes it.

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
from linrad_tpu.calibration import make_filtercorr
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu_torch import Demod, InputMode, convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.pipeline.chain import RxState, make_rx_step
from linrad_tpu_torch.pipeline.receiver import (MultiReceiver, Receiver,
                                                Transport)

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
    # the round-parallel clever blanker
    "rounds": dataclasses.replace(_TINY, fft1_variant="xla",
                                  blanker_rounds=8),
    # the matmul-DFT fft1 variants (four-step at fft1 256: 16 x 16)
    "mxu": dataclasses.replace(_TINY, fft1_variant="mxu"),
    "mxu-bf16": dataclasses.replace(_TINY, fft1_variant="mxu_bf16"),
    # a non-unity filtercorr through the kernel's plain version and xla
    "filtercorr-pallas": dataclasses.replace(_TINY, fft1_variant="pallas"),
    "filtercorr-xla": dataclasses.replace(_TINY, fft1_variant="xla"),
}
# the same configurations as the port's own RxParams
T_CONFIGS = {k: convert.params_from_jax(v) for k, v in CONFIGS.items()}
_T_TINY = convert.params_from_jax(_TINY)


def _calibration(name: str) -> dict | None:
    """The filtercorr-* configurations' calibration: make_filtercorr of a
    tilted, rippled response (16 dB across the band, a phase ramp), made
    by the JAX package's calibration module."""
    if not name.startswith("filtercorr"):
        return None
    n = t_derive_geometry(T_CONFIGS[name]).fft1_size
    k = np.fft.fftfreq(n)
    resp = ((10 ** (0.4 * k) * (1.0 + 0.2 * np.cos(12 * np.pi * k)))
            * np.exp(1j * 3.0 * k))
    return {"filtercorr": make_filtercorr(resp)}


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
    cal = _calibration(request.param)
    jrx = JaxReceiver(p, cal)
    trx = Receiver(T_CONFIGS[request.param], cal, device="cpu")
    if cal is not None:
        # the port builds the same calibrated tables from the dict
        np.testing.assert_array_equal(
            convert.flatten(trx.tables)["fft1.filtercorr"],
            convert.flatten(jrx.tables)["fft1.filtercorr"])
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
    p = T_CONFIGS["pallas"]
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
    rx = Receiver(T_CONFIGS["xla"], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        rx.process_block(np.zeros((rx.geo.samples_per_step - 1, 1),
                                  np.complex64))


def test_cuda_device_requires_cuda():
    """device="cuda", named or by default, raises where there is no CUDA
    device: no receiver carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(T_CONFIGS["pallas"], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(T_CONFIGS["pallas"])
    with pytest.raises(RuntimeError, match="cuda"):
        MultiReceiver(T_CONFIGS["pallas"], 2)


# refused before they were ported; tests/test_torch_eme.py,
# tests/test_torch_options.py, tests/test_torch_sharded*.py and the CONFIGS
# above hold them against JAX
PORTED_PARAMS = {
    "shards": dict(shards=2),
    "blanker-rounds": dict(blanker_rounds=2),
    "mxu": dict(fft1_variant="mxu"),
    "mxu-bf16": dict(fft1_variant="mxu_bf16"),
    "two-channel": dict(rx_rf_channels=2),
    "demod-am": dict(demod=Demod.AM),
    "demod-fm": dict(demod=Demod.FM),
    "demod-coherent": dict(demod=Demod.COHERENT),
    "demod-none": dict(demod=Demod.NONE),
    "afc": dict(afc_enable=True),
    "pol-adapt": dict(rx_rf_channels=2, pol_adapt_enable=True),
    "real-input": dict(input_mode=InputMode.REAL),
    "mixer-mode-2": dict(mixer_mode=2),
    "squelch": dict(squelch_enable=True),
    "expander": dict(expander_exponent=2.0),
    "spur": dict(spur_enable=True),
}


def test_calibration_positional():
    """Receiver(params, calibration) and MultiReceiver(params, K,
    calibration), positionally as in the JAX package: the filtercorr
    reaches the tables and changes fft1_power."""
    p = T_CONFIGS["filtercorr-xla"]
    cal = _calibration("filtercorr-xla")
    iq = _input(t_derive_geometry(p))[: t_derive_geometry(p).samples_per_step]
    fc = torch.from_numpy(cal["filtercorr"])
    powers = []
    for c in (cal, None):
        rx = Receiver(p, c, device="cpu")
        mrx = MultiReceiver(p, 2, c, device="cpu")
        if c is not None:
            assert torch.equal(rx.tables.fft1.filtercorr, fc)
            assert torch.equal(mrx.tables.fft1.filtercorr, fc)
        rx.tune(TUNE_HZ)
        out = rx.process_block(iq)
        mout = mrx.process_block(iq)
        assert torch.equal(out.fft1_power, mout.fft1_power)
        assert mout.audio.shape == (2,) + tuple(out.audio.shape)
        assert torch.isfinite(mout.audio).all()
        powers.append(out.fft1_power)
    assert not torch.equal(powers[0], powers[1])


def test_shards_on_one_device():
    """A shards=2 configuration (the sharded geometry) runs on one device
    through make_rx_step, Receiver and MultiReceiver alike: the step's
    first outputs equal the Receiver's, and MultiReceiver's row 0 tuned to
    the single step tuned to the same bin (atol 1e-5, as
    tests/test_torch_multi.py holds the rows)."""
    p = dataclasses.replace(_T_TINY, fft1_variant="xla", shards=2)
    geo = t_derive_geometry(p)
    assert geo.fft1_frames_per_step % 2 == 0
    rx = Receiver(p, device="cpu")
    rx.tune(TUNE_HZ)
    block = _input(geo)[: geo.samples_per_step]
    state0 = rx.state
    out = rx.process_block(block)
    step = make_rx_step(geo, p, rx.blanker_pulsewidth, True)
    _s, out2 = step(rx.tables, state0, torch.from_numpy(block),
                    rx._tune_bin, rx._tune_frac)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(out2, f)), f
    mrx = MultiReceiver(p, 2, device="cpu")
    mrx.tune_subch(0, TUNE_HZ)
    mout = mrx.process_block(block)
    plain = make_rx_step(geo, p, rx.blanker_pulsewidth)
    _s, out3 = plain(mrx.tables, RxState.create(geo, "cpu"),
                     torch.from_numpy(block), mrx._tune_bins[0])
    np.testing.assert_allclose(mout.audio[0].numpy(), out3.audio.numpy(),
                               atol=1e-5)
    assert float(out3.audio.abs().max()) > 0


@pytest.mark.parametrize("name", list(PORTED_PARAMS))
def test_ported_configuration(name):
    """A tiny Receiver builds and runs 5 steps (the AFC acquires after
    4) under each setting the port used to refuse."""
    p = dataclasses.replace(_T_TINY, **{"fft1_variant": "xla",
                                        **PORTED_PARAMS[name]})
    rx = Receiver(p, device="cpu")
    rx.tune(TUNE_HZ)
    iq = np.repeat(_input(rx.geo)[: 5 * rx.geo.samples_per_step],
                   rx.geo.channels, axis=1)
    if not rx.geo.iq_input:
        # 2S real samples per step at twice the rate: the same spectrum
        iq = np.repeat(iq.real, 2, axis=0)
    outs = list(rx.run(iq))
    assert len(outs) == 5
    audio_c = 1 if p.pol_adapt_enable else rx.geo.channels
    for out in outs:
        assert out.audio.shape == (rx.geo.baseband_samples_per_step, audio_c)
        assert torch.isfinite(out.audio).all()
    assert float(torch.cat([o.audio for o in outs]).abs().max()) > 0
    assert (rx.afc is not None) == p.afc_enable
    assert (rx.spur_manager is not None) == p.spur_enable
    if p.afc_enable:
        assert rx.control.host_reads == 5


def test_tune_slope_step():
    """The step takes tune_slope: a zero slope gives the plain
    fractional tuning bit for bit, a non-zero one changes the audio."""
    p = T_CONFIGS["xla"]
    rx = Receiver(p, device="cpu")
    rx.tune(TUNE_HZ)
    block = torch.from_numpy(_input(rx.geo)[: rx.geo.samples_per_step])
    step = make_rx_step(rx.geo, p, rx.blanker_pulsewidth, True)
    args = (rx.tables, rx.state, block, rx._tune_bin, rx._tune_frac)
    _s, plain = step(*args)
    _s, zero = step(*args, torch.zeros(()))
    _s, sloped = step(*args, torch.full((rx.geo.fftx_frames_per_step,), 0.3))
    assert torch.equal(plain.audio, zero.audio)
    assert not torch.equal(plain.audio, sloped.audio)
    assert torch.isfinite(sloped.audio).all()


class _Beat:
    """Stands in for runtime.watchdog's Watchdog and RealTimeMonitor."""

    def __init__(self):
        self.calls = []

    def beat(self, name):
        self.calls.append(name)

    def advance(self, n):
        self.calls.append(n)


@pytest.mark.parametrize("name", ["audio_out_rate", "iq_corr", "transport",
                                  "pace", "watchdog", "monitor", "hook"])
def test_refused_host_feature(name):
    """The host features the port used to refuse, each run for 3 steps."""
    p = T_CONFIGS["xla"]
    kw = {}
    if name == "audio_out_rate":
        kw["audio_out_rate"] = 2.0 * t_derive_geometry(
            p).baseband_sampling_speed
    if name == "iq_corr":
        kw["calibration"] = {"iq_corr": np.full(256, 0.01 + 0.02j,
                                                np.complex64)}
    rx = Receiver(p, device="cpu", **kw)
    rx.tune(TUNE_HZ)
    s = rx.geo.samples_per_step
    iq = _input(rx.geo)[: 3 * s]
    fired = []
    run_kw = {}
    stub = _Beat()
    if name == "hook":
        rx.add_hook("block", lambda r, out: fired.append(out))
    elif name == "transport":
        run_kw["transport"] = Transport()
    elif name == "pace":
        run_kw["pace"] = True
    elif name in ("watchdog", "monitor"):
        run_kw[name] = stub
    outs = list(rx.run(iq, **run_kw))
    assert len(outs) == 3
    bb = rx.geo.baseband_samples_per_step
    rows = 2 * bb if name == "audio_out_rate" else bb
    assert all(o.audio.shape == (rows, 1) for o in outs)
    assert all(torch.isfinite(o.audio).all() for o in outs)
    if name == "iq_corr":
        plain = Receiver(p, device="cpu")
        plain.tune(TUNE_HZ)
        ref = next(plain.run(iq))
        assert not torch.equal(ref.fft1_power, outs[0].fft1_power)
    if name == "hook":
        assert fired == outs
    if name == "watchdog":
        assert stub.calls == ["receiver"] * 3
    if name == "monitor":
        assert stub.calls == [s] * 3
