"""The port's own copies of the JAX package's configuration modules
(params, geometry, ops.windows, utils.llsq, weak.afc) against the
originals.  Everything here is host-side Python and numpy, so the bar is
equality: geometries field for field, windows and fits bit for bit, the
AFC's status, frame bins and frequency exactly.
"""

import dataclasses

import numpy as np
import pytest

import linrad_tpu as jpkg
import linrad_tpu_torch as tpkg
from __graft_entry__ import _flagship_params
from linrad_tpu.ops import windows as jwin
from linrad_tpu.utils import llsq as jllsq
from linrad_tpu.weak import afc as jafc
from linrad_tpu_torch import convert
from linrad_tpu_torch.ops import windows as twin
from linrad_tpu_torch.utils import llsq as tllsq
from linrad_tpu_torch.weak import afc as tafc

TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
            max_pulses_per_block=8)
EME = dict(rx_ad_speed=48_000, rx_rf_channels=2, pol_adapt_enable=True,
           fft1_variant="pallas")

PARAMS = {f"preset-{m.name}": jpkg.preset(m) for m in jpkg.RxMode}
PARAMS.update({
    "flagship": _flagship_params(),
    "flagship-tiny": _flagship_params(tiny=True),
    "eme": jpkg.preset(jpkg.RxMode.WCW, **EME),
    "eme-tiny": jpkg.preset(jpkg.RxMode.WCW, **EME, **TINY),
    # fields the presets leave at their defaults
    "filter-curve": jpkg.RxParams(notches=((300.0, 50.0), (-700.0, 20.0)),
                                  filter_shape=((-1000.0, -6.0),
                                                (1000.0, 3.0)),
                                  first_fft_sinpow=3, fft3_sinpow=1,
                                  mix2_reduction_n=1),
    "real-input": jpkg.RxParams(input_mode=jpkg.InputMode.REAL,
                                second_fft_enable=True, second_fft_sinpow=4,
                                second_fft_ninc=2),
})


@pytest.mark.parametrize("name", list(PARAMS))
def test_params_from_jax(name):
    """Field for field, as the port's own types; a dict goes as well as
    the dataclass; JSON written by one package reads back in the other."""
    jp = PARAMS[name]
    tp = convert.params_from_jax(jp)
    assert type(tp) is tpkg.RxParams and type(tp) is not type(jp)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert type(tp.demod) is tpkg.Demod
    assert type(tp.input_mode) is tpkg.InputMode
    assert convert.params_from_jax(dataclasses.asdict(jp)) == tp
    assert tpkg.RxParams.from_json(jp.to_json()) == tp
    assert tp.to_json() == jp.to_json()


def test_params_from_jax_refuses_other_fields():
    d = dataclasses.asdict(PARAMS["flagship"])
    with pytest.raises(ValueError, match="fields differ"):
        convert.params_from_jax({**d, "no_such_field": 1})
    d.pop("bfo_hz")
    with pytest.raises(ValueError, match="fields differ"):
        convert.params_from_jax(d)


def test_enums_and_fields_match():
    for name in ("InputMode", "RxMode", "Demod"):
        j, t = getattr(jpkg, name), getattr(tpkg, name)
        assert {m.name: m.value for m in j} == {m.name: m.value for m in t}
    for jc, tc in ((jpkg.RxParams, tpkg.RxParams),
                   (jpkg.Geometry, tpkg.Geometry),
                   (jafc.AFCConfig, tafc.AFCConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(jc)] == \
            [(f.name, f.default) for f in dataclasses.fields(tc)]


@pytest.mark.parametrize("mode", list(jpkg.RxMode), ids=lambda m: m.name)
def test_preset(mode):
    """The port's preset() gives the JAX package's, with overrides."""
    assert tpkg.preset(tpkg.RxMode(int(mode))) == \
        convert.params_from_jax(jpkg.preset(mode))
    assert tpkg.preset(tpkg.RxMode(int(mode)), **EME, **TINY) == \
        convert.params_from_jax(jpkg.preset(mode, **EME, **TINY))


@pytest.mark.parametrize("name", list(PARAMS))
def test_derive_geometry(name):
    jp = PARAMS[name]
    jgeo = jpkg.derive_geometry(jp)
    tgeo = tpkg.derive_geometry(convert.params_from_jax(jp))
    assert type(tgeo) is tpkg.Geometry
    assert dataclasses.asdict(tgeo) == dataclasses.asdict(jgeo)
    for prop in ("fftx_size", "fftx_new_points", "fftx_interleave_points",
                 "fftx_bandwidth", "decimation"):
        assert getattr(tgeo, prop) == getattr(jgeo, prop), prop


def test_interleave_ratio_and_bad_params():
    for sinpow in (0, 1, 2, 3, 4, 8, 9):
        assert tpkg.geometry.interleave_ratio(sinpow) == \
            jpkg.interleave_ratio(sinpow)
    for bad in (dict(rx_rf_channels=3), dict(first_fft_sinpow=5),
                dict(second_fft_sinpow=0), dict(fft3_sinpow=3)):
        with pytest.raises(ValueError):
            tpkg.RxParams(**bad)
        with pytest.raises(ValueError):
            jpkg.RxParams(**bad)


def _window_cases():
    """(size, sinpow) of every analysis window the geometries build."""
    cases = set()
    for jp in PARAMS.values():
        geo = jpkg.derive_geometry(jp)
        cases.add((geo.fft1_size, geo.fft1_sinpow))
        cases.add((geo.fft3_size, geo.fft3_sinpow))
        if geo.second_fft_enable:
            cases.add((geo.fft2_size, geo.fft2_sinpow))
    cases.update({(256, 0), (256, 8), (512, 9)})
    return sorted(cases)


def _synthesis_cases():
    """(size, interleave points, sinpow) of every synthesis-weight table
    the port's stages build (timf2, mix1, mix2)."""
    cases = set()
    for jp in PARAMS.values():
        geo = jpkg.derive_geometry(jp)
        cases.add((geo.fft1_size, geo.fft1_interleave_points,
                   geo.fft1_sinpow))
        cases.add((geo.mix1_size, geo.mix1_interleave_points,
                   geo.fft2_sinpow if geo.second_fft_enable
                   else geo.fft1_sinpow))
        cases.add((geo.mix2_size, geo.mix2_size - geo.mix2_new_points,
                   geo.fft3_sinpow))
    return sorted(cases)


@pytest.mark.parametrize("size,sinpow", _window_cases())
def test_make_window(size, sinpow):
    for normalize in (False, True):
        a = twin.make_window(size, sinpow, normalize)
        b = jwin.make_window(size, sinpow, normalize)
        assert a.dtype == b.dtype and a.shape == (size,)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,interleave,sinpow", _synthesis_cases())
def test_synthesis_weights(size, interleave, sinpow):
    a = twin.synthesis_weights(size, interleave, sinpow)
    b = jwin.synthesis_weights(size, interleave, sinpow)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    new = size - interleave
    win = jwin.make_window(size, sinpow)
    assert twin.crossover_points(size, interleave, new, sinpow, win) == \
        jwin.crossover_points(size, interleave, new, sinpow, win)


@pytest.mark.parametrize("seed", range(4))
def test_llsq(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        y = rng.uniform(0.1, 10.0, size=3)
        assert tllsq.parabolic_peak(*y) == jllsq.parabolic_peak(*y)
    assert tllsq.parabolic_peak(1.0, 1.0, 1.0) == \
        jllsq.parabolic_peak(1.0, 1.0, 1.0)
    for degree in (0, 1, 2):
        t = np.sort(rng.uniform(-20.0, 0.0, size=10))
        f = 1000.0 + 0.05 * t + 0.001 * t ** 2 + rng.normal(size=10) * 0.01
        w = rng.uniform(1.0, 100.0, size=10)
        np.testing.assert_array_equal(tllsq.polyfit_drift(t, f, degree, w),
                                      jllsq.polyfit_drift(t, f, degree, w))
    basis = rng.normal(size=(12, 3))
    y = rng.normal(size=12)
    np.testing.assert_array_equal(tllsq.llsq_fit(basis, y),
                                  jllsq.llsq_fit(basis, y))
    x = rng.normal(size=64)
    np.testing.assert_array_equal(tllsq.mask_tophat_filter(5, x),
                                  jllsq.mask_tophat_filter(5, x))


def _afc_spectra(geo, steps: int, seed: int, drift_hz_s: float,
                 fade_from: int | None) -> list:
    """Seeded power spectra of a carrier near 1005 Hz drifting
    drift_hz_s over exponential noise; the carrier vanishes from step
    fade_from on."""
    rng = np.random.default_rng(seed)
    n = geo.fftx_size
    bw = geo.timf1_sampling_speed / n
    step_s = geo.samples_per_step / geo.timf1_sampling_speed
    out = []
    for i in range(steps):
        p = rng.exponential(size=n)
        if fade_from is None or i < fade_from:
            f = (1005.0 + drift_hz_s * i * step_s) / bw
            k = np.arange(n)
            p = p + 400.0 * np.sinc(k - f) ** 2
        out.append(p)
    return out


def _drive(afc_mod, geo, spectra, coherent: bool):
    """The Receiver's AFC schedule: acquire from 4 spectra, then update;
    per step (status, freq_hz, ston, tuning arrays)."""
    trk = afc_mod.AFCTracker(geo, afc_mod.AFCConfig(
        fit_points=10, max_drift_hz_per_s=5.0))
    trk.freq_hz = 1000.0
    step_s = geo.samples_per_step / geo.timf1_sampling_speed
    n = geo.fftx_frames_per_step
    buf, track = [], []
    for i, power in enumerate(spectra):
        now = (i + 1) * step_s
        if trk.status in (0, 1):
            buf.append(power)
            if len(buf) >= 4:
                trk.acquire(np.stack(buf), trk.freq_hz, step_s)
                buf.clear()
        else:
            trk.update(power, now)
        tuning = ()
        if trk.status in (2, 3, 4):
            tuning = (trk.frame_tuning(now + step_s, n) if coherent
                      else (trk.frame_bins(now + step_s, n),))
        track.append((trk.status, trk.freq_hz, trk.ston,
                      trk.predict(now + step_s), tuning))
    return track


@pytest.mark.parametrize("coherent", [True, False],
                         ids=["frame_tuning", "frame_bins"])
@pytest.mark.parametrize("case", ["drift", "steady", "fade", "noise"])
@pytest.mark.parametrize("config", ["eme-tiny", "preset-QRSS"])
def test_afc_tracker(config, case, coherent):
    """12 steps of the same seeded spectra through both trackers."""
    jp = PARAMS[config]
    jgeo = jpkg.derive_geometry(jp)
    tgeo = tpkg.derive_geometry(convert.params_from_jax(jp))
    drift = {"drift": 0.05, "steady": 0.0, "fade": 0.02, "noise": 0.0}[case]
    fade = {"fade": 8, "noise": 0}.get(case)
    spectra = _afc_spectra(jgeo, 12, seed=11, drift_hz_s=drift,
                           fade_from=fade)
    j_track = _drive(jafc, jgeo, spectra, coherent)
    t_track = _drive(tafc, tgeo, spectra, coherent)
    statuses = [t[0] for t in t_track]
    if case == "noise":
        assert set(statuses) <= {0, 1}, statuses
    else:
        assert 3 in statuses, statuses
    for i, (j, t) in enumerate(zip(j_track, t_track)):
        assert t[:4] == j[:4], f"step {i}: {t[:4]} != {j[:4]}"
        assert len(t[4]) == len(j[4])
        for a, b in zip(t[4], j[4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
