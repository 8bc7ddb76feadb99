"""The receive chain's options, port against JAX package: squelch and
expander, mixer mode 2, real input, I/Q image correction and the audio
resampler.

Each module that the options add goes through the JAX function and the
port's on the same numpy-seeded inputs; then the slice as a whole, the
port's Receiver against the JAX package's over 8 steps at
_flagship_params(tiny=True) (fft1 256, fft2 512, 1,024 samples per step),
from the same tables and state carried across by
linrad_tpu_torch.convert.  The JAX side runs jitted on the CPU, its Pallas
kernel in interpret mode where the configuration selects it.

Bars as tests/test_torch_chain.py: liminfo signs, blanker counts and the
squelch's open/shut decision exact, liminfo <= 1e-5, audio <= 2.3e-4,
fft2_power <= 1e-6, squelch gate <= 1e-6, every other float field and the
final state <= 1e-4 (agc_gain in the start-up step 0: the audio's bar).  The last section runs the JAX package's own
behavioural tests of these options on the port alone.
"""

import dataclasses
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import derive_geometry
from linrad_tpu.io.siggen import Tone, gaussian_noise, tones_iq
from linrad_tpu.ops import fft1 as jfft1
from linrad_tpu.ops import mix2 as jmix2
from linrad_tpu.ops import resample as jresample
from linrad_tpu.ops import squelch as jsquelch
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu_torch import Demod, InputMode, RxParams, convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import mix2 as tmix2
from linrad_tpu_torch.ops import resample as tresample
from linrad_tpu_torch.ops import squelch as tsquelch
from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
from linrad_tpu_torch.pipeline.receiver import Receiver, Transport

STEPS = 8
TUNE_HZ = 12_345.6
FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER_BAR = 1e-4
FP32 = 1e-5

_TINY = _flagship_params(tiny=True)


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _cnoise(rng, shape, scale=1.0):
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


def _geo_pair(**kw):
    p = dataclasses.replace(_TINY, **kw)
    tp = convert.params_from_jax(p)
    return p, derive_geometry(p), tp, t_derive_geometry(tp)


# ---- modules against JAX ---------------------------------------------

@pytest.mark.parametrize("variant", [None, "pallas"])
def test_fft1_step_real(variant):
    """Real input over 3 blocks: 2N real samples per frame, DC + i*Nyquist
    packed into bin 0; "pallas" takes the torch.fft path on both sides and
    launches no kernel."""
    p, geo, _tp, tgeo = _geo_pair(input_mode=0)
    jt = jfft1.FFT1Tables.create(geo)
    tt = tfft1.FFT1Tables.create(tgeo, "cpu")
    np.testing.assert_array_equal(tt.window.numpy(), np.asarray(jt.window))
    np.testing.assert_array_equal(tt.filtercorr.numpy(),
                                  np.asarray(jt.filtercorr))
    js = jfft1.FFT1State.create(geo)
    ts = tfft1.FFT1State.create(tgeo, "cpu")
    assert ts.tail.shape == np.shape(js.tail) and ts.tail.dtype == torch.float32
    rng = np.random.default_rng(31)
    before = fused_fft1.launches
    for _ in range(3):
        blk = rng.normal(size=(2 * geo.samples_per_step, 1)).astype(
            np.float32) + 0.5
        js, jspec, jpow = jfft1.fft1_step(geo, jt, js, jnp.asarray(blk), 8,
                                          variant=variant)
        ts, tspec, tpow = tfft1.fft1_step(tgeo, tt, ts, _t(blk), 8,
                                          variant=variant)
        assert tspec.shape == (geo.fft1_frames_per_step, geo.fft1_size, 1)
        assert _max_rel(tspec.numpy(), jspec) <= FP32
        assert _max_rel(tpow.numpy(), jpow) <= FP32
        # bin 0 holds the Nyquist component in its imaginary part
        assert float(tspec[:, 0].imag.abs().max()) > 0
    assert _max_rel(ts.sumsq_avg.numpy(), js.sumsq_avg) <= FP32
    np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))
    assert fused_fft1.launches == before


def test_fft1_real_step():
    p, geo, _tp, tgeo = _geo_pair(input_mode=0)
    rng = np.random.default_rng(32)
    win = jfft1.FFT1Tables.create(geo).window
    tail = rng.normal(size=(2 * geo.fft1_interleave_points, 1)).astype(
        np.float32)
    blk = rng.normal(size=(2 * geo.samples_per_step, 1)).astype(np.float32)
    jspec, jtail = jfft1.fft1_real_step(geo, win, jnp.asarray(tail),
                                        jnp.asarray(blk))
    tspec, ttail = tfft1.fft1_real_step(tgeo, _t(win), _t(tail), _t(blk))
    assert _max_rel(tspec.numpy(), jspec) <= FP32
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("variant", [None, "pallas"])
def test_fft1_step_iq_corr(variant):
    """X[k] - c[k]*conj(X[-k]) with the mirror index (-k) % N; with iq_corr
    "pallas" takes the torch.fft path and launches no kernel."""
    p, geo, _tp, tgeo = _geo_pair()
    rng = np.random.default_rng(33)
    corr = _cnoise(rng, (geo.fft1_size,), 0.05)
    jt = jfft1.FFT1Tables.create(geo, iq_corr=corr)
    tt = tfft1.FFT1Tables.create(tgeo, "cpu", iq_corr=corr)
    np.testing.assert_array_equal(tt.iq_corr.numpy(), np.asarray(jt.iq_corr))
    js = jfft1.FFT1State.create(geo)
    ts = tfft1.FFT1State.create(tgeo, "cpu")
    before = fused_fft1.launches
    for _ in range(2):
        blk = _cnoise(rng, (geo.samples_per_step, 1))
        js, jspec, jpow = jfft1.fft1_step(geo, jt, js, jnp.asarray(blk), 8,
                                          variant=variant)
        ts, tspec, tpow = tfft1.fft1_step(tgeo, tt, ts, _t(blk), 8,
                                          variant=variant)
        assert _max_rel(tspec.numpy(), jspec) <= FP32
        assert _max_rel(tpow.numpy(), jpow) <= FP32
    assert fused_fft1.launches == before
    # the correction is not a plain flip: a flip would pair bin 0 with N-1
    plain = tfft1.FFT1Tables.create(tgeo, "cpu")
    _s, uncorrected, _p = tfft1.fft1_step(
        tgeo, plain, tfft1.FFT1State.create(tgeo, "cpu"), _t(blk), 8)
    assert not torch.equal(uncorrected, tspec)


@pytest.mark.parametrize("reduction,coherent", [(0, False), (1, True),
                                                (2, False)])
def test_mix2_fir_and_carrier_step(reduction, coherent):
    """The mixer-mode-2 FIR at strides 1, 2 and 4 over 3 blocks, and the
    carrier branch beside it."""
    kw = dict(mixer_mode=2, mix2_reduction_n=reduction)
    if coherent:
        kw["demod"] = 4
    p, geo, tp, tgeo = _geo_pair(**kw)
    jt = jmix2.Mix2Tables.create(geo, p)
    tt = tmix2.Mix2Tables.create(tgeo, tp, "cpu")
    np.testing.assert_array_equal(tt.fir.numpy(), np.asarray(jt.fir))
    k = tt.fir.shape[0]
    jf = jmix2.Mix2FirState.create(geo, k)
    tf = tmix2.Mix2FirState.create(tgeo, k, "cpu")
    jm = jmix2.Mix2State.create(geo)
    tm = tmix2.Mix2State.create(tgeo, "cpu")
    rng = np.random.default_rng(34)
    s3 = geo.fft3_new_points * 4
    resamp = geo.fft3_size // geo.mix2_size
    assert resamp == 1 << reduction
    for _ in range(3):
        timf3 = _cnoise(rng, (s3, 1))
        jf, jb = jmix2.mix2_fir_step(geo, jt.fir, jf, jnp.asarray(timf3))
        tf, tb = tmix2.mix2_fir_step(tgeo, tt.fir, tf, _t(timf3))
        assert tb.shape == (s3 // resamp, 1) and tb.dtype == torch.complex64
        assert _max_rel(tb.numpy(), jb) <= FP32
        np.testing.assert_array_equal(tf.carry.numpy(), np.asarray(jf.carry))
        spec = _cnoise(rng, (4, geo.fft3_size, 1))
        jm, jc = jmix2.mix2_carrier_step(geo, jt, jm, jnp.asarray(spec))
        tm, tc = tmix2.mix2_carrier_step(tgeo, tt, tm, _t(spec))
        assert _max_rel(tc.numpy(), jc) <= FP32
        assert torch.equal(tm.ola_carry, torch.zeros_like(tm.ola_carry))
        assert _max_rel(tm.carr_ola_carry.numpy(), jm.carr_ola_carry) <= FP32


def test_mix2_fir_step_window_is_a_view():
    """The (M, K) windows come from unfold: no copy of the stream."""
    x = torch.arange(40, dtype=torch.float32)[:, None]
    win = x.unfold(-2, 7, 2)
    assert win.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()


def _squelch_inputs(rng, geo, level):
    spec = _cnoise(rng, (4, geo.fft3_size, 1))
    spec[:, 3] += level            # an in-band line
    audio = rng.normal(size=(geo.baseband_samples_per_step, 1)).astype(
        np.float32)
    return spec, audio


def test_squelch_step():
    """Gate value <= 1e-6 and the open/shut decision exact over 6 steps:
    noise alone (shut), then an in-band line 30 times the noise (open)."""
    p, geo, tp, tgeo = _geo_pair(filter_low_hz=-1000.0, filter_high_hz=1000.0)
    jfilt = jmix2.Mix2Tables.create(geo, p).filt
    tfilt = tmix2.Mix2Tables.create(tgeo, tp, "cpu").filt
    js = jsquelch.SquelchState.create()
    ts = tsquelch.SquelchState.create("cpu")
    rng = np.random.default_rng(35)
    opened = []
    for level in (0.0, 0.0, 0.0, 30.0, 30.0, 30.0):
        spec, audio = _squelch_inputs(rng, geo, level)
        j_prev = float(js.gate)
        js, ja, jg = jsquelch.squelch_step(geo, js, jnp.asarray(spec), jfilt,
                                           20.0, 5.0, jnp.asarray(audio))
        t_prev = float(ts.gate)
        ts, ta, tg = tsquelch.squelch_step(tgeo, ts, _t(spec), tfilt, 20.0,
                                           5.0, _t(audio))
        assert abs(float(tg) - float(jg)) <= 1e-6
        assert float(ts.gate) == float(tg)
        assert (float(tg) > t_prev) == (float(jg) > j_prev)
        opened.append(float(tg) > t_prev)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=1e-6)
    assert opened == [False, False, False, True, True, True]


def test_squelch_step_stacked():
    """(K,) gates from (K, n3, N, C) spectra: row k is the single call."""
    _p, _geo, tp, tgeo = _geo_pair()
    filt = tmix2.Mix2Tables.create(tgeo, tp, "cpu").filt
    rng = np.random.default_rng(36)
    rows = [_squelch_inputs(rng, tgeo, lv) for lv in (0.0, 30.0, 0.0)]
    spec = _t(np.stack([r[0] for r in rows]))
    audio = _t(np.stack([r[1] for r in rows]))
    st = tsquelch.SquelchState(gate=torch.tensor([0.0, 0.5, 1.0]))
    st2, out, gate = tsquelch.squelch_step(tgeo, st, spec, filt, 20.0, 5.0,
                                           audio)
    assert gate.shape == (3,) and out.shape == audio.shape
    for k in range(3):
        one = tsquelch.SquelchState(gate=st.gate[k])
        _s, o1, g1 = tsquelch.squelch_step(tgeo, one, spec[k], filt, 20.0,
                                           5.0, audio[k])
        assert torch.equal(g1, gate[k]) and torch.equal(o1, out[k])


@pytest.mark.parametrize("exponent", [1.0, 2.0, 3.5])
def test_expander(exponent):
    rng = np.random.default_rng(37)
    x = (rng.normal(size=(500, 2)) * 0.7).astype(np.float32)
    x[0, 0] = 0.0
    jy = jsquelch.expander(jnp.asarray(x), exponent)
    ty = tsquelch.expander(_t(x), exponent)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("taps", [4, 32])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("rates", [(6000.0, 12000.0), (6000.0, 8000.0),
                                   (8000.0, 6000.0)])
def test_resampler(taps, kind, rates):
    """Index and weight tables exact, outputs <= 1e-5 over 3 blocks."""
    fs_in, fs_out = rates
    jdt, tdt = ((jnp.float32, torch.float32) if kind == "real"
                else (jnp.complex64, torch.complex64))
    jr = jresample.Resampler(fs_in, fs_out, 96, 2, dtype=jdt, taps=taps)
    tr = tresample.Resampler(fs_in, fs_out, 96, 2, "cpu", dtype=tdt,
                             taps=taps)
    assert (tr.p, tr.q, tr.block_out) == (jr.p, jr.q, jr.block_out)
    np.testing.assert_array_equal(tr._idx.numpy(), np.asarray(jr._idx))
    np.testing.assert_array_equal(tr._w.numpy(), np.asarray(jr._w))
    js, ts = jr.init_state(), tr.init_state()
    rng = np.random.default_rng(38)
    for _ in range(3):
        x = (rng.normal(size=(96, 2)).astype(np.float32) if kind == "real"
             else _cnoise(rng, (96, 2)))
        js, jy = jr(js, jnp.asarray(x))
        ts, ty = tr(ts, _t(x))
        assert ty.shape == (tr.block_out, 2) and ty.dtype == tdt
        assert _max_rel(ty.numpy(), jy) <= FP32
        np.testing.assert_array_equal(ts.history.numpy(),
                                      np.asarray(js.history))


def test_resampler_refuses_non_integer_output():
    with pytest.raises(ValueError, match="non-integer"):
        tresample.Resampler(6000.0, 8000.0, 64 + 1, 1, "cpu")


# ---- the slice: Receiver against Receiver ----------------------------

def _iq_corr():
    rng = np.random.default_rng(41)
    return {"iq_corr": _cnoise(rng, (256,), 0.02)}


# name -> (RxParams overrides, Receiver keyword arguments)
OPTIONS = {
    "squelch-expander": (dict(fft1_variant="xla", squelch_enable=True,
                              squelch_ratio=12.0, squelch_tc_ms=20.0,
                              expander_exponent=2.0), {}),
    "mixer2": (dict(fft1_variant="pallas", mixer_mode=2), {}),
    "mixer2-coherent-stride2": (dict(fft1_variant="xla", mixer_mode=2,
                                     mix2_reduction_n=1, demod=4), {}),
    "real": (dict(fft1_variant="pallas", input_mode=0), {}),
    "real-no-fft2": (dict(input_mode=0, second_fft_enable=False,
                          blanker_enable=False), {}),
    "iq_corr": (dict(fft1_variant="pallas"), {"calibration": _iq_corr()}),
    "audio_out_rate": (dict(fft1_variant="xla"),
                       {"audio_out_rate": 12_000.0}),
}


def _input(geo, keyed: bool) -> np.ndarray:
    """Gaussian noise, a strong carrier (liminfo strong bins), 12 impulses
    per step (both blankers work) and a tone at the dial: steady, or (for
    the squelch) absent in steps 0-3 and 25 times stronger in steps 4-7.
    Complex, or for real input 2S real samples per step."""
    rng = np.random.default_rng(2)
    real = not geo.iq_input
    rows = (2 if real else 1) * geo.samples_per_step
    n = STEPS * rows
    t = np.arange(n) / geo.rx_ad_speed
    carrier_hz = 30_000.0 if real else -20_000.0
    amp = np.where(np.arange(n) < n // 2, 0.0, 50.0) if keyed else 2.0
    x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         + 100.0 * np.exp(2j * np.pi * carrier_hz * t)
         + amp * np.exp(2j * np.pi * (TUNE_HZ + 300.0) * t))
    for s in range(STEPS):
        pos = s * rows + rng.integers(0, rows, 12)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=12))
    if real:
        return x.real.astype(np.float32)[:, None]
    return x.astype(np.complex64)[:, None]


@pytest.fixture(scope="module", params=list(OPTIONS))
def runs(request):
    overrides, rx_kw = OPTIONS[request.param]
    p = dataclasses.replace(_TINY, **overrides)
    jrx = JaxReceiver(p, **rx_kw)
    trx = Receiver(convert.params_from_jax(p), device="cpu", **rx_kw)
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    iq = _input(jrx.geo, keyed=p.squelch_enable)
    before = fused_fft1.launches
    j_out, t_out, j_gate, t_gate = [], [], [], []
    for out in jrx.run(iq):
        j_out.append(out)
        j_gate.append(float(jrx.state.squelch.gate))
    for out in trx.run(iq):
        t_out.append(out)
        t_gate.append(float(trx.state.squelch.gate))
    assert len(j_out) == len(t_out) == STEPS
    return dict(name=request.param, p=p, jrx=jrx, trx=trx, j_out=j_out,
                t_out=t_out, j_gate=j_gate, t_gate=t_gate,
                launches=fused_fft1.launches - before)


@pytest.mark.parametrize("field", FIELDS)
def test_field_parity(runs, field):
    name, p = runs["name"], runs["p"]
    jv = [getattr(o, field) for o in runs["j_out"]]
    tv = [getattr(o, field) for o in runs["t_out"]]
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
    if field == "agc_gain":
        # In step 0 the output ramps up from the zero tails and the gain
        # is target / envelope of samples 100 times below the settled
        # level: the baseband's 4e-6 of its maximum is 1e-4 of those, and
        # the gain inherits it (1.3e-4 measured with real input).  It is
        # held to the audio's bar there and to 1e-4 from step 1 on.
        assert _max_rel(t_arr[0], j_arr[0]) <= BARS["audio"], name
        t_arr, j_arr = t_arr[1:], j_arr[1:]
    assert _max_rel(t_arr, j_arr) <= BARS.get(field, OTHER_BAR), name


def test_final_state(runs):
    jrx, trx = runs["jrx"], runs["trx"]
    ref = convert.flatten(jrx.state)
    port = convert.state_to_numpy(trx.state)
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        assert v.shape == ref[k].shape, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= OTHER_BAR, k
    if trx._resampler is not None:
        assert _max_rel(trx._resampler_state.history.numpy(),
                        jrx._resampler_state.history) <= OTHER_BAR


def test_option_took_effect(runs):
    """Each option does its work in the compared run (the comparison is not
    vacuous), the kernel is launched only where the JAX package reaches
    its Pallas kernel, and the squelch's decisions agree exactly."""
    name, p, trx = runs["name"], runs["p"], runs["trx"]
    t_out = runs["t_out"]
    assert max(float(o.audio.abs().max()) for o in t_out) > 0
    # on the CPU the wrapper's plain version runs and counts no launch
    assert runs["launches"] == 0
    bb = trx.geo.baseband_samples_per_step
    if name == "audio_out_rate":
        assert all(o.audio.shape == (2 * bb, 1) for o in t_out)
        assert trx._resampler.block_out == 2 * bb
    else:
        assert all(o.audio.shape[0] == bb for o in t_out)
    if p.mixer_mode == 2:
        assert trx.state.mix2_fir is not None
        assert float(trx.state.mix2_fir.carry.abs().max()) > 0
        assert float(trx.state.mix2.ola_carry.abs().max()) == 0
    if name.startswith("real"):
        assert trx.state.fft1.tail.dtype == torch.float32
        assert trx.geo.timf1_sampling_speed == trx.geo.rx_ad_speed / 2
    if name == "iq_corr":
        assert trx.tables.fft1.iq_corr is not None
    if p.squelch_enable:
        jg, tg = np.array(runs["j_gate"]), np.array(runs["t_gate"])
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
        t_open = np.diff(np.concatenate([[0.0], tg])) > 0
        j_open = np.diff(np.concatenate([[0.0], jg])) > 0
        np.testing.assert_array_equal(t_open, j_open)
        # shut on noise alone, open once the tone is there
        assert not t_open[:3].any() and t_open[5:].all(), t_open
    else:
        assert all(g == 0.0 for g in runs["t_gate"])


def test_tiny_real_block_is_not_cast_to_complex():
    p = convert.params_from_jax(dataclasses.replace(_TINY, input_mode=0))
    rx = Receiver(p, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        rx.process_block(np.zeros((rx.geo.samples_per_step, 1), np.float32))
    out = rx.process_block(np.ones((2 * rx.geo.samples_per_step,),
                                   np.float64))
    assert out.fft1_power.shape == (rx.geo.fft1_size, 1)
    assert rx.state.fft1.tail.dtype == torch.float32


# ---- the JAX package's behavioural tests, on the port alone ----------

def _fit_tone_snr(z: np.ndarray, freq_hz: float, fs: float) -> float:
    """SNR (dB) of a complex stream against the best-fit tone at freq."""
    t = np.arange(len(z)) / fs
    ref = np.exp(2j * np.pi * freq_hz * t)
    amp = np.vdot(ref, z) / len(z)
    resid = z - amp * ref
    return 10 * np.log10(np.vdot(z, z).real
                         / max(np.vdot(resid, resid).real, 1e-30))


def _rx(audio_out_rate=None, **kw):
    kw.setdefault("first_fft_bandwidth", 100.0)
    kw.setdefault("mix1_bandwidth_reduction_n", 4)
    kw.setdefault("agc_enable", False)
    return Receiver(RxParams(**kw), device="cpu",
                    audio_out_rate=audio_out_rate)


def _small(**kw):
    kw.setdefault("fft1_n_override", 9)
    kw.setdefault("target_fft1_frames_per_step", 8)
    return _rx(**kw)


def test_mixer_mode2_fir_amplitude_and_purity():
    rx = _rx(mixer_mode=2, mix2_reduction_n=2, demod=Demod.NONE)
    g = rx.geo
    fc, delta = 12_000.0, 150.0
    rx.tune(fc)
    iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 10, [Tone(fc + delta)])
    z = rx.process(iq)["baseb"][:, 0]
    zz = z[len(z) // 3:]
    snr = _fit_tone_snr(zz, delta, g.baseband_sampling_speed)
    assert snr > 60.0, snr
    assert np.abs(zz).mean() == pytest.approx(1.0, rel=2e-2)


def test_mixer_mode2_matches_frequency_domain_path():
    common = dict(mix2_reduction_n=2, demod=Demod.NONE,
                  filter_low_hz=-400.0, filter_high_hz=400.0)
    amps = {}
    for mode in (1, 2):
        rx = _rx(mixer_mode=mode, **common)
        g = rx.geo
        rx.tune(12_000.0)
        iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 8,
                      [Tone(12_150.0),
                       Tone(12_000.0 + 0.45 * g.baseband_sampling_speed,
                            amplitude=10.0)])
        z = rx.process(iq)["baseb"][:, 0]
        zz = z[len(z) // 3:]
        t = np.arange(len(zz)) / g.baseband_sampling_speed
        amps[mode] = np.abs(np.vdot(np.exp(2j * np.pi * 150.0 * t), zz)
                            / len(zz))
        snr = _fit_tone_snr(zz, 150.0, g.baseband_sampling_speed)
        assert snr > 40.0, (mode, snr)
    assert amps[2] == pytest.approx(amps[1], rel=2e-2)


def test_squelch_gates_noise_opens_on_signal():
    rx = _rx(squelch_enable=True, squelch_ratio=4.0, squelch_tc_ms=5.0,
             filter_low_hz=-300.0, filter_high_hz=300.0)
    g = rx.geo
    rx.tune(12_000.0)
    rng = np.random.default_rng(0)
    n = g.samples_per_step * 8
    iq = gaussian_noise(rng, n, level_bits=-10)
    sig = tones_iq(g.rx_ad_speed, n, [Tone(12_100.0, amplitude=0.5)])
    iq[n // 2:] += sig[n // 2:]
    audio = rx.process(iq)["audio"][:, 0]
    q = len(audio) // 4
    closed_rms = np.sqrt(np.mean(audio[q: 2 * q] ** 2))
    open_rms = np.sqrt(np.mean(audio[3 * q:] ** 2))
    assert open_rms > 20.0 * max(closed_rms, 1e-12)


def test_notch_removes_tone():
    base = dict(filter_low_hz=-1000.0, filter_high_hz=1000.0)
    results = {}
    for notch in ((), ((500.0, 80.0),)):
        rx = _rx(**base, notches=notch)
        g = rx.geo
        rx.tune(12_000.0)
        iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 4,
                      [Tone(12_200.0), Tone(12_500.0)])
        z = rx.process(iq)["baseb"][:, 0]
        zz = z[len(z) // 2:]
        t = np.arange(len(zz)) / g.baseband_sampling_speed

        def pwr(f):
            return abs(np.vdot(np.exp(2j * np.pi * f * t), zz)
                       / len(zz)) ** 2

        results[bool(notch)] = (pwr(200.0), pwr(500.0))
    assert results[True][0] / results[False][0] > 0.7      # 200 Hz kept
    assert 10 * np.log10(results[True][1] / results[False][1]) < -30.0


def test_expander_suppresses_quiet():
    rx = _rx(agc_enable=True, expander_exponent=2.0)
    g = rx.geo
    rx.tune(12_000.0)
    n = g.samples_per_step * 4
    rng = np.random.default_rng(2)
    sig = tones_iq(g.rx_ad_speed, n, [Tone(12_400.0, key_period_s=0.4,
                                           key_duty=0.5)])
    iq = sig + gaussian_noise(rng, n, level_bits=-12)
    audio = rx.process(iq)["audio"][:, 0]
    env = np.abs(audio[len(audio) // 2:])
    assert np.percentile(env, 90) / max(np.percentile(env, 30), 1e-12) > 50.0


def test_real_mode_rate_halved():
    g = t_derive_geometry(RxParams(input_mode=InputMode.REAL))
    assert g.timf1_sampling_speed == g.rx_ad_speed / 2


def test_real_mode_tone_through_chain():
    rx = _rx(input_mode=InputMode.REAL, filter_low_hz=-1000.0,
             filter_high_hz=1000.0)
    g = rx.geo
    rx.tune(12_000.0)
    n = 2 * g.samples_per_step * 4
    t = np.arange(n) / g.rx_ad_speed
    x = np.cos(2 * np.pi * 12_400.0 * t).astype(np.float32)
    z = rx.process(x)["baseb"][:, 0]
    zz = z[len(z) // 2:]
    tt = np.arange(len(zz)) / g.baseband_sampling_speed
    ref = np.exp(2j * np.pi * 400.0 * tt)
    amp = np.vdot(ref, zz) / len(zz)
    assert abs(amp) == pytest.approx(1.0, rel=5e-3)
    assert _fit_tone_snr(zz, 400.0, g.baseband_sampling_speed) > 45.0


def test_real_mode_spectrum_one_sided():
    rx = Receiver(RxParams(input_mode=InputMode.REAL, fft1_n_override=10,
                           agc_enable=False), device="cpu")
    g = rx.geo
    rx.tune(10_000.0)
    n = 2 * g.samples_per_step
    t = np.arange(n) / g.rx_ad_speed
    x = np.cos(2 * np.pi * 10_000.0 * t).astype(np.float32)
    power = rx.process_block(x[:, None]).fft1_power[:, 0].numpy()
    k = int(round(10_000.0 / (g.rx_ad_speed / 2) * g.fft1_size))
    assert abs(int(np.argmax(power)) - k) <= 1


def test_tune_rf_mapping():
    rx = _small(converter_offset_hz=116_000_000.0)
    rx.center_frequency_hz = 28_000_000.0
    rx.tune_rf(144_028_200.0)  # 2 m dial through a 116 MHz converter
    assert rx.tuned_hz == pytest.approx(28_200.0, abs=200.0)
    assert rx.tuned_rf_hz == pytest.approx(144_028_200.0, abs=200.0)


def test_inverting_converter():
    rx = _small(passband_direction=-1)
    rx.center_frequency_hz = 10_000_000.0
    rx.tune_rf(9_990_000.0)  # 10 kHz below centre, inverted
    assert rx.tuned_hz == pytest.approx(10_000.0, abs=200.0)
    assert rx.tuned_rf_hz == pytest.approx(9_990_000.0, abs=200.0)


def test_audio_output_rate():
    fs_bb = _small().geo.baseband_sampling_speed
    rx = _small(audio_out_rate=2 * fs_bb)
    g = rx.geo
    rx.tune(10_000.0)
    iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 4, [Tone(10_200.0)])
    audio = rx.process(iq)["audio"][:, 0]
    assert len(audio) == 2 * 4 * g.baseband_samples_per_step
    a = audio[len(audio) // 2:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    freqs = np.fft.rfftfreq(len(a), 1 / (2 * fs_bb))
    assert rx.tuned_hz == pytest.approx(10_000.0, abs=1e-3)
    assert freqs[np.argmax(spec)] == pytest.approx(
        (10_200.0 - rx.tuned_hz) + rx.params.bfo_hz, abs=5.0)


def test_hooks_fire_in_order():
    """tune on retune; per step extra_fast before the control update and
    block after it, as the JAX Receiver fires them."""
    rx = Receiver(convert.params_from_jax(dataclasses.replace(
        _TINY, afc_enable=True)), device="cpu")
    log = []
    rx.add_hook("tune", lambda r, f: log.append(("tune", f)))
    rx.add_hook("extra_fast",
                lambda r, out: log.append(("extra_fast",
                                           r.control.steps_done)))
    rx.add_hook("block",
                lambda r, out: log.append(("block", r.control.steps_done)))
    assert set(rx.hooks) == {"init", "extra_fast", "block", "tune"}
    rx.tune(TUNE_HZ)
    s = rx.geo.samples_per_step
    list(rx.run(np.zeros((2 * s, 1), np.complex64) + 1.0))
    assert log == [("tune", TUNE_HZ), ("extra_fast", 0), ("block", 1),
                   ("extra_fast", 1), ("block", 2)]
    with pytest.raises(KeyError):
        rx.add_hook("no-such-event", print)


def test_transport_pause_resume_seek():
    rx = Receiver(convert.params_from_jax(_TINY), device="cpu")
    s = rx.geo.samples_per_step
    step_s = s / rx.geo.timf1_sampling_speed
    # step i of the recording holds the constant i + 1
    iq = np.repeat(np.arange(1, 7), s).astype(np.complex64)[:, None]
    tr = Transport()
    seen = []
    process = rx.process_block

    def spy(block):
        seen.append(int(block[0, 0].real))
        return process(block)

    rx.process_block = spy
    gen = rx.run(iq, transport=tr)
    next(gen)
    next(gen)
    tr.seek(4.2 * step_s)          # forward, to step 4
    next(gen)
    tr.seek(0.0)                   # and back to the start
    next(gen)
    assert not tr.paused
    tr.pause()
    assert tr.paused
    timer = threading.Timer(0.2, tr.resume)
    timer.start()
    next(gen)                      # blocks until the timer resumes
    timer.join()
    assert not tr.paused
    tr.seek(1e9)                   # past the end: the run stops
    assert list(gen) == []
    assert seen == [1, 2, 5, 1, 2]


def test_pace_replays_in_real_time():
    import time
    rx = Receiver(convert.params_from_jax(dataclasses.replace(
        _TINY, second_fft_enable=False, blanker_enable=False)), device="cpu")
    s = rx.geo.samples_per_step
    step_s = s / rx.geo.timf1_sampling_speed
    iq = np.ones((6 * s, 1), np.complex64)
    t0 = time.monotonic()
    assert len(list(rx.run(iq, pace=True))) == 6
    assert time.monotonic() - t0 >= 5 * step_s
