"""The EME weak-signal path: the port's Receiver against the JAX package's
Receiver on the tiny form of the EME configuration

    preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
           pol_adapt_enable=True, fft1_variant=...)

(fft1 256, fft2 512, 1,024 samples per step): two-channel input,
adaptive polarization, coherent CW detection (modes 2 and 1) and the AFC
with drift tracking, 10 steps from the same tables and state carried
across by linrad_tpu_torch.convert.  The AM and FM presets run in their
one-channel tiny form.  With fft1_variant="pallas" the JAX side runs its
Pallas kernel in interpret mode, as tests/test_pallas.py runs it; the
port's kernel wrapper runs its plain version on the CPU.

The AFC's decisions are thresholds on host-side numpy, so its trajectory
is held first: status and frame bins exact per step, frequency within
1e-3 bin.  Output bars as tests/test_torch_chain.py: liminfo sign pattern
and blanker counts exact, liminfo <= 1e-5, audio <= 2.3e-4, fft2_power
<= 1e-6, every other float field and the final state <= 1e-4.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linrad_tpu import RxMode, derive_geometry, preset
from linrad_tpu.ops import demod as jdemod
from linrad_tpu.ops import mix1 as jmix1
from linrad_tpu.ops import mix2 as jmix2
from linrad_tpu.params import RxParams
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu.weak import pol as jpol
from linrad_tpu_torch import RxParams as TRxParams
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import demod as tdemod
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.ops import mix2 as tmix2
from linrad_tpu_torch.pipeline.chain import make_rx_step
from linrad_tpu_torch.pipeline.control import WeakSignalControl
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.weak import pol as tpol

STEPS = 10
TUNE_HZ = 1_000.0
POL_TRUE = np.array([0.8, 0.6j])
FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
WIDE_ONLY = ("fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
             "noise_floor")
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER_BAR = 1e-4
FP32 = 1e-5

TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
            max_pulses_per_block=8)


def eme_params(**kw) -> RxParams:
    return preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
                  pol_adapt_enable=True, **TINY, **kw)


CONFIGS = {
    "coherent2-pallas": eme_params(fft1_variant="pallas"),
    "coherent1-xla": eme_params(fft1_variant="xla", coherent_mode=1),
    "fm": preset(RxMode.FM, fm_deemphasis_us=75.0, **TINY),
    "am": preset(RxMode.AM, **TINY),
}
# the same configurations as the port's own RxParams
T_CONFIGS = {k: convert.params_from_jax(v) for k, v in CONFIGS.items()}


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


def eme_input(geo, steps: int, seed: int = 3) -> np.ndarray:
    """A keyed CW carrier 5 Hz above the dial drifting 0.05 Hz/s, split
    0.8 : 0.6j across the two channels; complex Gaussian noise; a strong
    carrier at -15 kHz (liminfo strong bins); 12 impulses per step (both
    blankers fit)."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 3).astype(np.float64)
    phase = 2 * np.pi * np.cumsum(TUNE_HZ + 5.0 + 0.05 * t) / fs
    tone = key * np.exp(1j * phase)
    x = tone[:, None] * POL_TRUE[None, :]
    x = x + rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    x = x + (100.0 * np.exp(2j * np.pi * -15_000.0 * t + 0.3j)[:, None]
             * np.array([1.0, 0.5]))
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += (300.0 * np.exp(2j * np.pi * rng.uniform(size=(12, 1)))
                   * np.array([1.0, 0.7]))
    return x.astype(np.complex64)


def broadcast_input(geo, steps: int, fm: bool, seed: int = 4) -> np.ndarray:
    """One channel: a carrier at the dial, amplitude-modulated 50% at
    400 Hz (AM) or frequency-modulated 3 kHz peak at 400 Hz (FM), plus
    complex Gaussian noise."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    mod = np.sin(2 * np.pi * 400.0 * t)
    if fm:
        phase = 2 * np.pi * np.cumsum(TUNE_HZ + 3000.0 * mod) / fs
        sig = 10.0 * np.exp(1j * phase)
    else:
        sig = 10.0 * (1 + 0.5 * mod) * np.exp(2j * np.pi * TUNE_HZ * t)
    return (sig + rng.normal(size=n) + 1j * rng.normal(size=n)
            ).astype(np.complex64)[:, None]


def _afc_point(rx, tune_bin, tune_frac, tune_slope):
    """(status, freq_hz, bins, frac, slope) after a step, as numpy."""
    def arr(v):
        return None if v is None else np.array(
            v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    afc = rx.afc
    return (afc.status if afc else None, afc.freq_hz if afc else None,
            arr(tune_bin), arr(tune_frac), arr(tune_slope))


def _run(rx, iq):
    outs, afc = [], []
    for out in rx.run(iq):
        outs.append(out)
        afc.append(_afc_point(rx, rx._tune_bin, rx._tune_frac,
                              rx._tune_slope))
    return outs, afc


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    """Both receivers over the same input from the same tables/state."""
    p = CONFIGS[request.param]
    jrx = JaxReceiver(p)
    trx = Receiver(T_CONFIGS[request.param], device="cpu")
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    geo = jrx.geo
    iq = (eme_input(geo, STEPS) if geo.channels == 2
          else broadcast_input(geo, STEPS, fm=request.param == "fm"))
    j_out, j_afc = _run(jrx, iq)
    t_out, t_afc = _run(trx, iq)
    assert len(j_out) == len(t_out) == STEPS
    return dict(name=request.param, p=p, jrx=jrx, trx=trx, j_out=j_out,
                t_out=t_out, j_afc=j_afc, t_afc=t_afc)


def test_afc_trajectory(runs):
    """Per step: AFC status and frame bins exact, frequency within 1e-3
    bin, (frac, slope) within fp32."""
    p, geo = runs["p"], runs["jrx"].geo
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    if not p.afc_enable:
        assert runs["jrx"].afc is None and runs["trx"].afc is None
        return
    for i, (j, t) in enumerate(zip(runs["j_afc"], runs["t_afc"])):
        assert t[0] == j[0], f"step {i}: status {t[0]} != {j[0]}"
        assert abs(t[1] - j[1]) <= 1e-3 * bin_hz, f"step {i}: freq_hz"
        np.testing.assert_array_equal(t[2].astype(np.int64),
                                      j[2].astype(np.int64))
        for k in (3, 4):
            assert (t[k] is None) == (j[k] is None), f"step {i}"
            if t[k] is not None:
                assert t[k].shape == j[k].shape
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=FP32)


@pytest.mark.parametrize("field", FIELDS)
def test_field_parity(runs, field):
    name, p = runs["name"], runs["p"]
    jv = [getattr(o, field) for o in runs["j_out"]]
    tv = [getattr(o, field) for o in runs["t_out"]]
    if not p.second_fft_enable and field in WIDE_ONLY:
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
    """The AFC reaches tracking and moves the tuning to per-frame
    (frac, slope); the blankers fit pulses; liminfo has strong bins;
    the audio carries the signal."""
    p, j_out = runs["p"], runs["j_out"]
    assert max(float(np.abs(np.asarray(o.audio)).max()) for o in j_out) > 0
    assert np.asarray(j_out[-1].audio).shape[1] == (
        2 if p.demod.name == "COHERENT" and p.coherent_mode == 1 else 1)
    if not p.second_fft_enable:
        return
    statuses = [a[0] for a in runs["j_afc"]]
    assert 3 in statuses, statuses
    assert runs["t_afc"][-1][4] is not None
    assert runs["t_afc"][-1][4].shape == (runs["jrx"].geo.fftx_frames_per_step,)
    assert max(int(o.blanker_fitted) for o in j_out) > 0
    assert max(int(o.blanker_cleared) for o in j_out) > 0
    assert any((np.asarray(o.liminfo) > 0).any() for o in j_out)


def test_final_state(runs):
    """The carried state after 10 steps, pol.coherency and coh.phase
    included: integers exact, floats <= 1e-4."""
    jrx, trx = runs["jrx"], runs["trx"]
    ref = convert.flatten(jrx.state)
    port = convert.state_to_numpy(trx.state)
    assert set(port) == set(ref)    # squelch.gate too, created always
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= OTHER_BAR, k


def test_polarization_found(runs):
    """The adaptive weights point along the injected polarization, and
    pol_info reads the same ellipse from both packages."""
    if not runs["p"].pol_adapt_enable:
        return
    coh = runs["trx"].state.pol.coherency.numpy()
    w, vecs = np.linalg.eigh(coh)
    overlap = abs(np.vdot(vecs[:, -1], POL_TRUE)) / np.linalg.norm(POL_TRUE)
    assert overlap >= 0.95, overlap
    ti = tpol.pol_info(runs["trx"].state.pol)
    ji = jpol.pol_info(runs["jrx"].state.pol)
    assert abs(ti.tilt_deg - ji.tilt_deg) <= 1e-2
    assert abs(ti.axial_ratio_db - ji.axial_ratio_db) <= 1e-2
    assert abs(ti.coherence - ji.coherence) <= 1e-4


def test_retune_resets_afc(runs):
    trx = runs["trx"]
    if trx.afc is None:
        return
    trx.tune(TUNE_HZ + 100.0)
    assert trx.afc.status == 0 and trx._tune_slope is None
    assert trx._tune_bin.shape == () and abs(trx.tuned_hz
                                             - TUNE_HZ - 100.0) < 1e-3


def test_direct_step_with_per_frame_tuning():
    """make_rx_step takes per-frame (bins, frac, slope) tensors straight
    and gives what the Receiver gives for the same tuning."""
    p = T_CONFIGS["coherent2-pallas"]
    rx = Receiver(p, device="cpu")
    geo = rx.geo
    n = geo.fftx_frames_per_step
    block = eme_input(geo, 1)
    bins = torch.full((n,), 11, dtype=torch.int64)
    frac = torch.linspace(-0.2, 0.2, n, dtype=torch.float32)
    slope = torch.full((n,), 0.4 / n, dtype=torch.float32)
    rx._tune_bin, rx._tune_frac, rx._tune_slope = bins, frac, slope
    state0 = rx.state
    out = rx.process_block(block)
    step = make_rx_step(geo, p, rx.blanker_pulsewidth, True)
    _s, out2 = step(rx.tables, state0, torch.from_numpy(block), bins, frac,
                    slope)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(out2, f)), f
    assert rx.control.host_reads == 1


def test_spur_half_refused():
    """The spur half of the control, refused until it was ported, now
    builds its manager beside the AFC; tests/test_torch_spur.py holds it
    against JAX."""
    p = dataclasses.replace(T_CONFIGS["coherent2-pallas"], spur_enable=True)
    ctl = WeakSignalControl(t_derive_geometry(p), p, "cpu")
    assert ctl.spur_manager is not None and ctl.afc is not None
    assert ctl.spur_scan_interval >= 1 and ctl.host_reads == 0


# ---- modules against JAX ---------------------------------------------

def _coherent_inputs(rng, s=300, c=1):
    carrier = (_cnoise(rng, (s, c), 0.1)
               + 3.0 * np.exp(0.4j + 0.01j * np.arange(s))[:, None]
               ).astype(np.complex64)
    return _cnoise(rng, (s, c)), carrier


@pytest.mark.parametrize("channels", [1, 2])
def test_coherent_detect(channels):
    rng = np.random.default_rng(21)
    j_st = jdemod.CoherentState.create(channels)
    t_st = tdemod.CoherentState.create(channels, "cpu")
    for _ in range(3):
        baseb, carrier = _coherent_inputs(rng, c=channels)
        j_st, ji, jq = jdemod.coherent_detect(j_st, jnp.asarray(baseb),
                                              jnp.asarray(carrier), 1500.0)
        t_st, ti, tq = tdemod.coherent_detect(t_st, _t(baseb), _t(carrier),
                                              1500.0)
        assert _max_rel(ti.numpy(), ji) <= FP32
        assert _max_rel(tq.numpy(), jq) <= FP32
        assert _max_rel(t_st.phase.numpy(), j_st.phase) <= FP32


def test_am_detect():
    rng = np.random.default_rng(22)
    j_st, t_st = jdemod.AMState.create(2), tdemod.AMState.create(2, "cpu")
    for _ in range(3):
        z = _cnoise(rng, (500, 2)) + 4.0
        j_st, ja = jdemod.am_detect(j_st, jnp.asarray(z), 3000.0)
        t_st, ta = tdemod.am_detect(t_st, _t(z), 3000.0)
        assert _max_rel(ta.numpy(), ja) <= FP32
        assert _max_rel(t_st.dc.numpy(), j_st.dc) <= FP32


def test_fm_detect_and_deemphasis():
    rng = np.random.default_rng(23)
    j_st, t_st = jdemod.FMState.create(1), tdemod.FMState.create(1, "cpu")
    ph = 0.0
    for _ in range(3):
        dph = 0.5 * np.sin(np.arange(400) / 7.0)
        phase = ph + np.cumsum(dph)
        ph = phase[-1]
        z = (np.exp(1j * phase)[:, None] + _cnoise(rng, (400, 1), 0.05)
             ).astype(np.complex64)
        j_st, ja = jdemod.fm_detect(j_st, jnp.asarray(z), 24000.0)
        t_st, ta = tdemod.fm_detect(t_st, _t(z), 24000.0)
        assert _max_rel(ta.numpy(), ja) <= FP32
        np.testing.assert_array_equal(t_st.last.numpy(), np.asarray(j_st.last))
        jd, jl = jdemod.fm_deemphasis(ja, 24000.0, 75.0, j_st.deemph)
        td, tl = tdemod.fm_deemphasis(ta, 24000.0, 75.0, t_st.deemph)
        assert _max_rel(td.numpy(), jd) <= FP32
        j_st = jdemod.FMState(last=j_st.last, deemph=jl)
        t_st = tdemod.FMState(last=t_st.last, deemph=tl)
        assert _max_rel(t_st.deemph.numpy(), j_st.deemph) <= FP32


@pytest.mark.parametrize("case", ["polarized", "x-only", "y-only"])
def test_update_polarization(case):
    """The closed-form eigenvector, including the axis choice when the
    off-diagonal term vanishes."""
    rng = np.random.default_rng(24)
    j_st, t_st = jpol.PolState.create(), tpol.PolState.create("cpu")
    for _ in range(4):
        s = _cnoise(rng, (256,))
        if case == "polarized":
            x = s[:, None] * POL_TRUE[None, :] + _cnoise(rng, (256, 2), 0.3)
        else:
            x = np.zeros((256, 2), np.complex64)
            x[:, 0 if case == "x-only" else 1] = 3.0 * s
        x = x.astype(np.complex64)
        j_st, jc, jw = jpol.update_polarization(j_st, jnp.asarray(x))
        t_st, tc, tw = tpol.update_polarization(t_st, _t(x))
        assert _max_rel(tw.numpy(), jw) <= FP32
        assert _max_rel(tc.numpy(), jc) <= FP32
        assert _max_rel(t_st.coherency.numpy(), j_st.coherency) <= FP32


def test_mix2_with_carrier():
    p, tp = CONFIGS["coherent2-pallas"], T_CONFIGS["coherent2-pallas"]
    geo, tgeo = derive_geometry(p), t_derive_geometry(tp)
    rng = np.random.default_rng(25)
    j_tab = jmix2.Mix2Tables.create(geo, p)
    t_tab = tmix2.Mix2Tables.create(tgeo, tp, "cpu")
    np.testing.assert_array_equal(t_tab.carr_filt.numpy(),
                                  np.asarray(j_tab.carr_filt))
    j_st, t_st = jmix2.Mix2State.create(geo), tmix2.Mix2State.create(tgeo,
                                                                     "cpu")
    for _ in range(3):
        spec = _cnoise(rng, (geo.fft3_frames_per_step, geo.fft3_size, 2))
        j_st, jb, jc = jmix2.mix2_step(geo, j_tab, j_st, jnp.asarray(spec),
                                       with_carrier=True)
        t_st, tb, tc = tmix2.mix2_step(tgeo, t_tab, t_st, _t(spec),
                                       with_carrier=True)
        assert _max_rel(tb.numpy(), jb) <= FP32
        assert _max_rel(tc.numpy(), jc) <= FP32
        assert _max_rel(t_st.carr_ola_carry.numpy(),
                        j_st.carr_ola_carry) <= FP32
    _s, _b, none = tmix2.mix2_step(tgeo, t_tab, t_st, _t(spec))
    assert none is None


@pytest.mark.parametrize("per_frame", [False, True])
def test_mix1_with_slope(per_frame):
    """mix1_step with tune_slope (and frac_ramp under it), three steps so
    the fractional phase carries."""
    geo = derive_geometry(CONFIGS["coherent2-pallas"])
    tgeo = t_derive_geometry(T_CONFIGS["coherent2-pallas"])
    n = geo.fftx_frames_per_step
    rng = np.random.default_rng(26)
    j_tab, t_tab = jmix1.Mix1Tables.create(geo), tmix1.Mix1Tables.create(
        tgeo, "cpu")
    j_st, t_st = jmix1.Mix1State.create(geo), tmix1.Mix1State.create(tgeo,
                                                                     "cpu")
    if per_frame:
        frac = np.linspace(-0.45, 0.3, n).astype(np.float32)
        slope = rng.uniform(-0.3, 0.3, n).astype(np.float32)
        bins = np.full(n, 37, np.int32)
    else:
        frac, slope, bins = (np.float32(0.21), np.float32(-0.13),
                             np.int32(37))
    for _ in range(3):
        spec = _cnoise(rng, (n, geo.fftx_size, 2), 10.0)
        j_st, jy = jmix1.mix1_step(geo, j_tab, j_st, jnp.asarray(spec),
                                   jnp.asarray(bins),
                                   tune_frac=jnp.asarray(frac),
                                   tune_slope=jnp.asarray(slope))
        t_st, ty = tmix1.mix1_step(tgeo, t_tab, t_st, _t(spec),
                                   _t(bins), tune_frac=_t(frac),
                                   tune_slope=_t(slope))
        assert _max_rel(ty.numpy(), jy) <= FP32
        assert int(t_st.phase_idx) == int(j_st.phase_idx)
        assert abs(float(t_st.frac_phase) - float(j_st.frac_phase)) <= 1e-6
    jr, jp = jmix1.frac_ramp(geo, jnp.float32(0.3), jnp.asarray(frac),
                             jnp.asarray(slope), n)
    tr, tp = tmix1.frac_ramp(tgeo, torch.tensor(0.3), _t(frac), _t(slope), n)
    assert _max_rel(tr.numpy(), jr) <= FP32
    assert abs(float(tp) - float(jp)) <= 1e-6


def test_slope_requires_frac():
    geo = t_derive_geometry(T_CONFIGS["coherent2-pallas"])
    with pytest.raises(ValueError, match="tune_frac"):
        tmix1.mix1_step(geo, None, None,
                        torch.zeros((geo.fftx_frames_per_step,
                                     geo.fftx_size, 2),
                                    dtype=torch.complex64),
                        torch.tensor(3), tune_slope=torch.tensor(0.1))


# ---- port mirror of tests/test_mix1_slope.py -------------------------

FS = 96_000.0


def _mix_drifting(use_slope: bool):
    p = TRxParams(fft1_n_override=10, target_fft1_frames_per_step=64,
                  agc_enable=False)
    geo = t_derive_geometry(p)
    n = geo.fft1_size
    newp = geo.fft1_new_points
    nframes = geo.fft1_frames_per_step
    f0, rate = 12000.0, 4000.0          # Hz, Hz/s
    t = np.arange(geo.samples_per_step) / FS
    iq = np.exp(2j * np.pi * np.cumsum(f0 + rate * t) / FS).astype(
        np.complex64)
    mids_hz = f0 + rate * ((np.arange(nframes + 1) + 0.5) * newp) / FS
    tbins = mids_hz * n / FS
    c0 = int(round(tbins[nframes // 2]))
    bins = torch.full((nframes,), c0, dtype=torch.int64)
    frac = torch.from_numpy((tbins[:nframes] - c0).astype(np.float32))
    slope = torch.from_numpy(np.diff(tbins).astype(np.float32))
    t1, s1 = tfft1.FFT1Tables.create(geo, "cpu"), tfft1.FFT1State.create(
        geo, "cpu")
    s1, spec, _ = tfft1.fft1_step(geo, t1, s1, _t(iq[:, None]), avg1num=4)
    tm, sm = tmix1.Mix1Tables.create(geo, "cpu"), tmix1.Mix1State.create(
        geo, "cpu")
    _sm, timf3 = tmix1.mix1_step(geo, tm, sm, spec, bins, tune_frac=frac,
                                 tune_slope=slope if use_slope else None)
    out = timf3[:, 0].numpy()
    return out[len(out) // 8:], FS / (n // geo.mix1_size)


def _narrow_snr_db(z, fs):
    spec = np.abs(np.fft.fft(z * np.hanning(len(z)))) ** 2
    pk = int(np.argmax(spec))
    idx = np.arange(pk - 3, pk + 4) % len(z)
    tone = spec[idx].sum()
    return (10 * math.log10(tone / max(spec.sum() - tone, 1e-30)),
            np.fft.fftfreq(len(z), 1 / fs)[pk])


def test_slope_removes_sawtooth_fm():
    stepped, fs_t3 = _mix_drifting(use_slope=False)
    sloped, _ = _mix_drifting(use_slope=True)
    snr_step, res_step = _narrow_snr_db(stepped, fs_t3)
    snr_slope, res_slope = _narrow_snr_db(sloped, fs_t3)
    assert abs(res_step) < 60
    assert abs(res_slope) < 60
    assert snr_slope > snr_step + 10, (snr_slope, snr_step)
    assert snr_slope > 10


def test_zero_slope_matches_plain_frac():
    p = RxParams(fft1_n_override=10, target_fft1_frames_per_step=16,
                 agc_enable=False)
    jgeo = derive_geometry(p)
    geo = t_derive_geometry(convert.params_from_jax(p))
    rng = np.random.default_rng(0)
    iq = _cnoise(rng, (geo.samples_per_step, 1))
    t1, s1 = tfft1.FFT1Tables.create(geo, "cpu"), tfft1.FFT1State.create(
        geo, "cpu")
    _s1, spec, _ = tfft1.fft1_step(geo, t1, s1, _t(iq), avg1num=4)
    tm = tmix1.Mix1Tables.create(geo, "cpu")
    frac = torch.tensor(0.3)
    _, a = tmix1.mix1_step(geo, tm, tmix1.Mix1State.create(geo, "cpu"),
                           spec, torch.tensor(128), tune_frac=frac)
    _, b = tmix1.mix1_step(geo, tm, tmix1.Mix1State.create(geo, "cpu"),
                           spec, torch.tensor(128), tune_frac=frac,
                           tune_slope=torch.tensor(0.0))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # and the JAX version on the same spectra
    _, j = jmix1.mix1_step(jgeo, jmix1.Mix1Tables.create(jgeo),
                           jmix1.Mix1State.create(jgeo),
                           jnp.asarray(spec.numpy()), jnp.int32(128),
                           tune_frac=jnp.float32(0.3),
                           tune_slope=jnp.float32(0.0))
    assert _max_rel(b.numpy(), j) <= FP32
