"""The port's copy of the calibration module (linrad_tpu_torch/calibration.py)
against the original, linrad_tpu/calibration.py, mirroring
tests/test_calibration.py.  Both are numpy on the host, so the bar is
equality: every public function gives the same arrays bit for bit, the
averager the same state after every interval, and a file written by one
package reads back in the other.  The chain-level case (a filtercorr from
make_filtercorr through both Receivers) is in tests/test_torch_chain.py.
"""

import dataclasses
import os

import numpy as np
import pytest
from scipy import signal as sps

import linrad_tpu as jpkg
from linrad_tpu import calibration as jcal
from linrad_tpu_torch import calibration as tcal
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry

RIPPLE = np.array([1.0, 0.0, 0.45, 0.0, -0.2])


def _geos(**kw):
    kw.setdefault("fft1_n_override", 9)
    jp = jpkg.RxParams(**kw)
    return (jpkg.derive_geometry(jp),
            t_derive_geometry(convert.params_from_jax(jp)))


def _pulse_train(fft1_size, h=None, n_pulses=12, seed=0, noise=0.05,
                 channels=1, ch1_phase=0.0):
    """Pulse generator recording, optionally through a channel h."""
    rng = np.random.default_rng(seed)
    n = fft1_size * 2 * (n_pulses + 1)
    x = np.zeros((n, channels), np.complex64)
    for k in range(1, n_pulses + 1):
        x[k * fft1_size * 2, :] = 1000.0
    if h is not None:
        x = sps.lfilter(h, [1.0], x, axis=0).astype(np.complex64)
    if channels > 1:
        x[:, 1] *= np.exp(1j * ch1_phase)
    x += noise * (rng.normal(size=x.shape)
                  + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    return x


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        for u, v in zip(a, b, strict=True):
            _same(u, v)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_public_names_match():
    def public(m):
        return sorted(n for n in vars(m) if not n.startswith("_")
                      and callable(getattr(m, n)) and n not in
                      ("Geometry", "annotations"))
    assert public(tcal) == public(jcal)
    assert tcal.CAL_MODES == jcal.CAL_MODES
    assert tcal._PULPTS == jcal._PULPTS


@pytest.mark.parametrize("channels,h", [(1, None), (1, RIPPLE),
                                        (2, RIPPLE)])
def test_measure_response(channels, h):
    jgeo, tgeo = _geos()
    x = _pulse_train(jgeo.fft1_size, h=h, channels=channels, ch1_phase=0.6)
    _same(tcal.measure_response(x, tgeo), jcal.measure_response(x, jgeo))
    _same(tcal.measure_response(x, tgeo, threshold_rel=0.5,
                                return_count=True),
          jcal.measure_response(x, jgeo, threshold_rel=0.5,
                                return_count=True))
    if channels == 1:
        _same(tcal.measure_response(x[:, 0], tgeo),
              jcal.measure_response(x[:, 0], jgeo))
    with pytest.raises(ValueError, match="no calibration pulses"):
        tcal.measure_response(np.zeros((4096, 1), np.complex64), tgeo)


@pytest.mark.parametrize("desired,max_boost", [(None, 10.0), ("tilt", 4.0)])
def test_make_filtercorr(desired, max_boost):
    jgeo, tgeo = _geos()
    resp = jcal.measure_response(_pulse_train(jgeo.fft1_size, h=RIPPLE),
                                 jgeo)
    want = None
    if desired == "tilt":
        want = np.linspace(0.5, 1.5, jgeo.fft1_size)
    got = tcal.make_filtercorr(resp, want, max_boost)
    _same(got, jcal.make_filtercorr(resp, want, max_boost))
    _same(tcal.make_filtercorr(resp[:, 0]), jcal.make_filtercorr(resp[:, 0]))
    # the correction flattens the rippled channel (test_calibration.py)
    total = np.abs(resp[:, 0] * tcal.make_filtercorr(resp)[:, 0])
    good = total > 0
    assert 20 * np.log10(total[good].max() / total[good].min()) < 1.0


def test_align_channel_phases():
    jgeo, _tgeo = _geos()
    x = _pulse_train(jgeo.fft1_size, channels=2, ch1_phase=0.6, noise=0.001)
    resp = jcal.measure_response(x, jgeo)
    _same(tcal.align_channel_phases(resp), jcal.align_channel_phases(resp))
    _same(tcal.align_channel_phases(resp, n_refine=1),
          jcal.align_channel_phases(resp, n_refine=1))
    _same(tcal.align_channel_phases(resp[:, :1]),
          jcal.align_channel_phases(resp[:, :1]))
    _same(tcal._band_limited_pulse(resp[:, 1]),
          jcal._band_limited_pulse(resp[:, 1]))


@pytest.mark.parametrize("channels", [1, 2])
def test_cal_averager(channels):
    """Four intervals: the same correction, response, delta and counts
    after each, and the same convergence verdicts."""
    jgeo, tgeo = _geos()
    ja, ta = jcal.CalAverager(jgeo), tcal.CalAverager(tgeo)
    for seed in range(4):
        x = _pulse_train(jgeo.fft1_size, h=RIPPLE, seed=seed,
                         channels=channels, ch1_phase=0.4)
        _same(ta.feed(x), ja.feed(x))
        assert (ta.delta, ta.pulse_count, ta.updates) == \
            (ja.delta, ja.pulse_count, ja.updates)
        _same(ta.response, ja.response)
        _same(ta.filtercorr, ja.filtercorr)
        for tol in (1e-3, 0.05):
            assert ta.converged(tol) == ja.converged(tol)
    fresh = tcal.CalAverager(tgeo)
    with pytest.raises(ValueError):
        fresh.response
    with pytest.raises(ValueError):
        fresh.filtercorr


def test_iq_balance():
    jgeo, tgeo = _geos()
    rng = np.random.default_rng(1)
    n = jgeo.fft1_size * 64
    train = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)
    bad = tcal.iq_imbalance(train, 1.05, 0.03)
    _same(bad, jcal.iq_imbalance(train, 1.05, 0.03))
    for segs in (8, 3):
        _same(tcal.estimate_iq_balance(bad, tgeo, bal_segments=segs),
              jcal.estimate_iq_balance(bad, jgeo, bal_segments=segs))
    c = jcal.estimate_iq_balance(bad, jgeo)
    spec = np.fft.fft(bad[: 4 * jgeo.fft1_size].reshape(4, -1, 1), axis=1)
    _same(tcal.apply_iq_correction(spec, c),
          jcal.apply_iq_correction(spec, c))


def test_persistence_across_packages(tmp_path):
    fc = (np.ones(512) * 1.5 + 0.25j).astype(np.complex64)
    iqc = (0.01j * np.ones((512, 1))).astype(np.complex64)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tcal.save_calibration(a, filtercorr=fc, iq_corr=iqc)
    jcal.save_calibration(b, filtercorr=fc)
    for load in (tcal.load_calibration, jcal.load_calibration):
        got = load(a)
        _same(got["filtercorr"], fc)
        _same(got["iq_corr"], iqc)
        assert list(load(b)) == ["filtercorr"]


def test_mode_calibration_files(tmp_path):
    d = str(tmp_path)
    for mode in tcal.CAL_MODES:
        for iq in (False, True):
            assert tcal.mode_cal_path(d, mode, iq) == \
                jcal.mode_cal_path(d, mode, iq)
    with pytest.raises(ValueError):
        tcal.mode_cal_path(d, "nosuchmode")
    fc = (np.ones(64) + 0.1j).astype(np.complex64)
    iqc = (0.02j * np.ones((64, 1))).astype(np.complex64)
    tcal.save_mode_calibration(d, "ssb", filtercorr=fc, iq_corr=iqc)
    tcal.copy_mode_calibration(d, "ssb", ["wcw", "cw"])
    for m in ("ssb", "wcw", "cw"):
        got, ref = tcal.load_mode_calibration(d, m), \
            jcal.load_mode_calibration(d, m)
        assert sorted(got) == sorted(ref) == ["filtercorr", "iq_corr"]
        for k in got:
            _same(got[k], ref[k])
    assert tcal.load_mode_calibration(d, "fm") == {}
    assert sorted(os.listdir(d)) == sorted(
        os.path.basename(jcal.mode_cal_path(d, m, iq))
        for m in ("ssb", "wcw", "cw") for iq in (False, True))


def test_geometry_fields_used_match():
    """The functions read fft1_size only from the geometry; the port's
    Geometry has the original's fields and values."""
    jgeo, tgeo = _geos(rx_rf_channels=2)
    assert dataclasses.asdict(tgeo) == dataclasses.asdict(jgeo)
