"""Spur cancellation, port against JAX package.

- ``spur_subtract_step`` on the same spectra and state, two active spurs
  (one on its bin, one at fractional offset 0.37), over 3 steps: cleaned
  spectra and the carried amp/rot/frac <= 1e-4.
- ``SpurManager.scan``: the same decisions (slot bins, drops, re-centres,
  the protected range) on the same inputs, exactly.
- The slice: Receiver against Receiver with ``spur_enable`` at
  _flagship_params(tiny=True) over 10 steps, ``control.spur_scan_interval``
  set to 2 on both so that scans fire at this step size; slot bins exact
  after every step, fields within the bars of tests/test_torch_chain.py.
- The JAX package's behavioural test (a carrier 500 Hz off the signal goes
  down by more than 20 dB, the signal stays within 3 dB) on the port alone.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import derive_geometry
from linrad_tpu.io.siggen import Tone, tones_iq
from linrad_tpu.ops.windows import make_window
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu.weak import spur as jspur
from linrad_tpu_torch import RxParams, convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.weak import spur as tspur

STEPS = 10
TUNE_HZ = 12_345.6
CARRIER_HZ = -20_100.0
FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
WIDE_ONLY = ("fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
             "noise_floor")
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER_BAR = 1e-4

_TINY = _flagship_params(tiny=True)


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _spur_state(bins, frac, channels):
    b = np.full(jspur.MAX_SPURS, -1, np.int32)
    f = np.zeros(jspur.MAX_SPURS, np.float32)
    b[:len(bins)] = bins
    f[:len(frac)] = frac
    amp = np.zeros((jspur.MAX_SPURS, channels), np.complex64)
    rot = np.ones(jspur.MAX_SPURS, np.complex64)
    j = jspur.SpurState(bins=jnp.asarray(b), amp=jnp.asarray(amp),
                        rot=jnp.asarray(rot), frac=jnp.asarray(f))
    t = tspur.SpurState(bins=_t(b), amp=_t(amp), rot=_t(rot), frac=_t(f))
    return j, t


def _spectra(geo, n_frames, steps, channels, rng):
    """Windowed transforms at hop fftx_new_points of: a carrier on bin 100,
    a carrier at bin 300.37 drifting 0.02 bin per step, and noise."""
    n, hop = geo.fftx_size, geo.fftx_new_points
    total = (steps * n_frames - 1) * hop + n
    t = np.arange(total)
    f2 = (300.37 + 0.02 * t / (n_frames * hop)) / n
    x = (40.0 * np.exp(2j * np.pi * 100.0 / n * t + 0.4j)
         + 25.0 * np.exp(2j * np.pi * np.cumsum(f2) - 1.1j))
    x = x[:, None] * np.array([1.0, 0.6 - 0.3j])[None, :channels]
    # noise 47 dB below the carriers' peaks: the cleaned spectra are what
    # is left of a subtraction, so float32 rounding of the carriers' size
    # (1e-7 of 7,700) stands against this floor
    x = x + 3.0 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    win = make_window(n, 2)
    frames = np.stack([x[i * hop:i * hop + n] * win[:, None]
                       for i in range(steps * n_frames)])
    spec = np.fft.fft(frames, axis=1).astype(np.complex64)
    return spec.reshape(steps, n_frames, n, channels)


@pytest.mark.parametrize("n_frames,channels", [(4, 1), (12, 2), (2, 1)])
def test_spur_subtract_step(n_frames, channels):
    """4 frames is the tiny step (smoothing window 3), 12 reaches the full
    11-frame Savitzky-Golay window, 2 the flat kernel below 3 frames."""
    p = dataclasses.replace(_TINY, rx_rf_channels=channels)
    geo = derive_geometry(p)
    tgeo = t_derive_geometry(convert.params_from_jax(p))
    table = jspur.window_template_table(geo.fftx_size, geo.fft2_sinpow)
    js, ts = _spur_state([100, 300], [0.0, 0.37], channels)
    rng = np.random.default_rng(51)
    spectra = _spectra(geo, n_frames, 3, channels, rng)
    for step in range(3):
        js, jc = jspur.spur_subtract_step(geo, jnp.asarray(table), js,
                                          jnp.asarray(spectra[step]))
        spec_t = _t(spectra[step])
        ts, tc = tspur.spur_subtract_step(tgeo, _t(table), ts, spec_t)
        assert torch.equal(spec_t, _t(spectra[step]))    # input untouched
        assert tc.dtype == torch.complex64 and tc.shape == spec_t.shape
        assert _max_rel(tc.numpy(), jc) <= 1e-4, step
        np.testing.assert_array_equal(ts.bins.numpy(), np.asarray(js.bins))
        for name in ("amp", "rot", "frac"):
            tv = getattr(ts, name)
            assert tv.dtype == {"frac": torch.float32}.get(
                name, torch.complex64), name
            ref = np.asarray(getattr(js, name))
            if name == "amp":       # of the carriers' size: relative
                assert _max_rel(tv.numpy(), ref) <= 1e-4
            else:
                np.testing.assert_allclose(tv.numpy(), ref, rtol=0,
                                           atol=1e-4, err_msg=name)
    # the carriers went down, the rest of the spectrum stayed
    before = np.abs(spectra[2]) ** 2
    after = np.abs(tc.numpy()) ** 2
    for b in (100, 300):
        assert after[:, b].sum() < 0.01 * before[:, b].sum(), b
    away = np.r_[0:90, 110:290, 310:geo.fftx_size]
    np.testing.assert_array_equal(tc.numpy()[:, away], spectra[2][:, away])
    # inactive slots keep their state
    assert torch.equal(ts.rot[2:], torch.ones(jspur.MAX_SPURS - 2,
                                              dtype=torch.complex64))
    assert float(ts.amp[2:].abs().max()) == 0.0
    assert abs(float(ts.frac[1]) - 0.37) < 0.2 and float(ts.amp[0].abs()[0]) > 1


def test_spur_subtract_step_no_active_spur_is_identity():
    geo = t_derive_geometry(convert.params_from_jax(_TINY))
    _js, ts = _spur_state([], [], 1)
    rng = np.random.default_rng(52)
    spec = _t((rng.normal(size=(4, 512, 1)) + 1j * rng.normal(size=(4, 512, 1))
               ).astype(np.complex64))
    table = _t(tspur.window_template_table(512, 2))
    ts2, cleaned = tspur.spur_subtract_step(geo, table, ts, spec)
    assert torch.equal(cleaned, spec)
    for name in ("bins", "amp", "rot", "frac"):
        assert torch.equal(getattr(ts2, name), getattr(ts, name)), name


def _scan_pair(jm, tm, p, js, ts, **kw):
    js2 = jm.scan(p, js, **kw)
    ts2 = tm.scan(p, ts, **kw)
    for name in ("bins", "amp", "rot", "frac"):
        a, b = getattr(ts2, name).numpy(), np.asarray(getattr(js2, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tm._age == jm._age
    return js2, ts2


def test_spur_manager_scan_decisions():
    """Acquire two peaks (the strongest first; one inside the protected
    range and one too close to a held spur are passed over), re-centre a
    drifted one, then drop a faded one after the grace scans."""
    geo = derive_geometry(_TINY)
    tgeo = t_derive_geometry(convert.params_from_jax(_TINY))
    jm, tm = jspur.SpurManager(geo), tspur.SpurManager(tgeo)
    rng = np.random.default_rng(53)
    p = rng.uniform(0.5, 1.5, 512)
    p[[40, 200, 204, 330]] = [900.0, 500.0, 300.0, 700.0]
    p[60] = 20.0                      # below ston * median: no spur
    js, ts = _spur_state([], [], 1)
    js, ts = _scan_pair(jm, tm, p, js, ts, protect_lo=323, protect_hi=337)
    assert ts.bins[:3].tolist() == [40, 200, -1]
    # tracked amplitudes: slot 0 alive, slot 1 faint; slot 0 drifted by
    # +1.3 bins, slot 1 by -0.4 (stays)
    def with_tracking(state_j, state_t):
        amp = np.zeros((16, 1), np.complex64)
        amp[0], amp[1] = 30.0 + 5j, 0.1
        frac = np.zeros(16, np.float32)
        frac[0], frac[1] = 1.3, -0.4
        rot = np.ones(16, np.complex64)
        rot[0] = np.exp(0.3j)
        return (dataclasses.replace(state_j, amp=jnp.asarray(amp),
                                    frac=jnp.asarray(frac),
                                    rot=jnp.asarray(rot)),
                dataclasses.replace(state_t, amp=_t(amp), frac=_t(frac),
                                    rot=_t(rot)))
    js, ts = with_tracking(js, ts)
    p2 = rng.uniform(0.5, 1.5, 512)    # spurs cancelled: a flat spectrum
    js, ts = _scan_pair(jm, tm, p2, js, ts)
    assert ts.bins[:2].tolist() == [41, 200]
    assert abs(float(ts.frac[0]) - 0.3) < 1e-6
    assert ts.rot[0] == torch.tensor(np.complex64(np.exp(0.3j)))
    for i in range(8):                 # the grace period, then the drop
        js, ts = _scan_pair(jm, tm, p2, js, ts)
    assert ts.bins[:2].tolist() == [41, -1]
    assert ts.amp[1].abs().item() == 0 and ts.rot[1] == 1
    # the freed slot is the first one a new peak takes
    p2[450] = 400.0
    js, ts = _scan_pair(jm, tm, p2, js, ts)
    assert ts.bins[:3].tolist() == [41, 450, -1]
    assert ts.bins.dtype == torch.int32


# ---- the slice: Receiver against Receiver ----------------------------

CONFIGS = {
    "spur-pallas": dict(fft1_variant="pallas", spur_enable=True),
    "spur-xla-no-fft2": dict(fft1_variant="xla", spur_enable=True,
                             second_fft_enable=False, blanker_enable=False),
}


def _input(geo) -> np.ndarray:
    """Gaussian noise, a weak tone near the dial, 12 impulses per step, and
    the spur: a carrier at CARRIER_HZ, between two fft2 bins."""
    rng = np.random.default_rng(6)
    n = STEPS * geo.samples_per_step
    t = np.arange(n) / geo.timf1_sampling_speed
    x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         + 100.0 * np.exp(2j * np.pi * CARRIER_HZ * t)
         + 2.0 * np.exp(2j * np.pi * (TUNE_HZ + 300.0) * t))
    for s in range(STEPS):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=12))
    return x.astype(np.complex64)[:, None]


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    p = dataclasses.replace(_TINY, **CONFIGS[request.param])
    jrx = JaxReceiver(p)
    trx = Receiver(convert.params_from_jax(p), device="cpu")
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    assert jrx.control.spur_scan_interval == trx.control.spur_scan_interval
    jrx.control.spur_scan_interval = trx.control.spur_scan_interval = 2
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    iq = _input(jrx.geo)
    j_out, t_out, j_bins, t_bins = [], [], [], []
    for out in jrx.run(iq):
        j_out.append(out)
        j_bins.append(np.asarray(jrx.state.spur.bins).copy())
    for out in trx.run(iq):
        t_out.append(out)
        t_bins.append(trx.state.spur.bins.numpy().copy())
    assert len(j_out) == len(t_out) == STEPS
    return dict(name=request.param, p=p, jrx=jrx, trx=trx, j_out=j_out,
                t_out=t_out, j_bins=j_bins, t_bins=t_bins)


def test_slot_bins_exact_per_step(runs):
    geo = runs["jrx"].geo
    for i, (j, t) in enumerate(zip(runs["j_bins"], runs["t_bins"])):
        np.testing.assert_array_equal(t, j, err_msg=f"step {i}")
    carrier_bin = int(round(CARRIER_HZ / geo.timf1_sampling_speed
                            * geo.fftx_size)) % geo.fftx_size
    # nothing held before the first scan (step 2), the carrier after it
    assert (runs["t_bins"][0] < 0).all()
    held = [b for b in runs["t_bins"][-1] if b >= 0]
    assert any(abs(b - carrier_bin) <= 1 for b in held), (held, carrier_bin)
    assert runs["trx"].spur_manager is runs["trx"].control.spur_manager
    # per scan: the spectrum, the tuned bin, the four spur state tensors
    assert runs["trx"].control.host_reads == 6 * (STEPS // 2)


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


def test_final_state(runs):
    jrx, trx = runs["jrx"], runs["trx"]
    ref = convert.flatten(jrx.state)
    port = convert.state_to_numpy(trx.state)
    assert set(port) == set(ref) and "spur.rot" in port
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= OTHER_BAR, k


def test_carrier_cancelled_in_the_compared_run(runs):
    """The comparison is not vacuous: once the slot is held, the power at
    the carrier's bin falls more than 10 dB below its level before the
    first scan (4 frames a step and 12 impulses in each keep the tiny
    step's model from the depth a full-size step reaches)."""
    geo = runs["jrx"].geo
    field = "fft2_power" if runs["p"].second_fft_enable else "fft1_power"
    if not runs["p"].second_fft_enable:
        # fft1_power is taken before the subtraction; the cleaned spectra
        # feed mix1 only.  The tracked amplitude shows the model's grip.
        amp = runs["trx"].state.spur.amp.abs().max().item()
        assert amp > 1000.0
        return
    b = int(round(CARRIER_HZ / geo.timf1_sampling_speed * geo.fftx_size)
            ) % geo.fftx_size
    power = [float(getattr(o, field)[b - 1:b + 2].sum())
             for o in runs["t_out"]]
    assert power[-1] < 0.1 * power[0], power


def test_cancels_offchannel_carrier():
    base = dict(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                agc_enable=False, filter_low_hz=-1500.0,
                filter_high_hz=1500.0)
    results = {}
    for spur_on in (False, True):
        rx = Receiver(RxParams(**base, spur_enable=spur_on), device="cpu")
        g = rx.geo
        fs = g.rx_ad_speed
        rx.tune(12_400.0)  # tuned ON the desired signal
        f_sig = 12_400.0 - rx.tuned_hz   # true baseband offsets
        f_spur = 12_900.0 - rx.tuned_hz
        n = g.samples_per_step * 10
        rng = np.random.default_rng(0)
        iq = (tones_iq(fs, n, [Tone(12_400.0, amplitude=0.1)])
              + tones_iq(fs, n, [Tone(12_900.0, amplitude=20.0)])
              + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n)
                        ).astype(np.complex64))
        z = rx.process(iq)["baseb"][:, 0]
        zz = z[2 * len(z) // 3:]
        t = np.arange(len(zz)) / g.baseband_sampling_speed

        def pwr(f):
            return abs(np.vdot(np.exp(2j * np.pi * f * t), zz)
                       / len(zz)) ** 2

        results[spur_on] = (pwr(f_sig), pwr(f_spur))
    sig_off, spur_off = results[False]
    sig_on, spur_on_p = results[True]
    # spur suppressed by > 20 dB, signal within 3 dB
    assert 10 * np.log10(spur_off / spur_on_p) > 20.0
    assert abs(10 * np.log10(sig_on / sig_off)) < 3.0
