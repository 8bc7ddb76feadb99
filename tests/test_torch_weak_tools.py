"""The port's copies of weak/siganal.py, weak/eme.py and modes.py, and its
host-conversion helper utils/host.to_numpy, against the JAX package.

The modules are numpy on the host in both packages, so the bar is
equality: every array bit for bit, every float and string exactly.  Each
array entry point is also given a torch tensor of the same input and must
return what it returns for the numpy array.  The cases mirror
tests/test_weak.py's TestSiganal and TestEME and tests/test_viz_modes.py's
TestModes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from linrad_tpu import modes as jmodes
from linrad_tpu.tx import ssb_modulate as j_ssb_modulate
from linrad_tpu.weak import eme as jeme
from linrad_tpu.weak import siganal as jsig
from linrad_tpu_torch import modes as tmodes
from linrad_tpu_torch.utils.host import to_numpy
from linrad_tpu_torch.weak import eme as teme
from linrad_tpu_torch.weak import siganal as tsig

T0 = 1_767_225_600.0          # 2026-01-01 00:00 UTC


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_fields(a, b) -> None:
    """Two result dataclasses, field for field (arrays bit for bit)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


# ---- utils/host ------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, np.float64])
def test_to_numpy(dtype):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    ref = np.asarray(x, dtype)
    got = to_numpy(_t(x).requires_grad_(), dtype)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    # a numpy array comes back as np.asarray gives it, a sequence too
    assert to_numpy(x) is x
    np.testing.assert_array_equal(to_numpy([1.0, 2.0], dtype),
                                  np.asarray([1.0, 2.0], dtype))
    # a conjugated view of a complex tensor is resolved first
    z = _t(x.astype(np.complex64) * (1 + 2j))
    np.testing.assert_array_equal(to_numpy(z.conj()), np.conj(to_numpy(z)))


# ---- weak/siganal ----------------------------------------------------

def _mod_carrier(n, m_am, f_am, m_pm, f_pm, phase=0.3):
    t = np.arange(n)
    am = 1.0 + m_am * np.cos(2 * np.pi * f_am * t)
    pm = m_pm * np.sin(2 * np.pi * f_pm * t)
    return (am * np.exp(1j * (pm + phase))).astype(np.complex64)


def _two_channel():
    size = 512
    rng = np.random.default_rng(1)
    n = 16 * size
    common_pm = 0.02 * rng.normal(size=n).cumsum() * 1e-2
    base = np.exp(1j * common_pm)
    ch0 = base * (1 + 0.001 * rng.normal(size=n))
    ch1 = base * (1 + 0.001 * rng.normal(size=n))
    return np.stack([ch0, ch1], axis=1).astype(np.complex64)


SIGANAL = {
    "am-pm": (lambda: _mod_carrier(16 * 512, 0.02, 20 / 512, 0.04,
                                   40 / 512), 0),
    "noise": (lambda: (np.random.default_rng(0).normal(size=(4096, 2))
                       @ np.array([1.0, 1j])).astype(np.complex64), 0),
    "two-channel": (_two_channel, 2),
}


@pytest.mark.parametrize("case", list(SIGANAL))
def test_signal_analysis(case):
    make, sinpow = SIGANAL[case]
    x = make()
    got = tsig.signal_analysis(x, fft_n=9, sinpow=sinpow)
    _same_fields(got, jsig.signal_analysis(x, fft_n=9, sinpow=sinpow))
    _same_fields(tsig.signal_analysis(_t(x), fft_n=9, sinpow=sinpow), got)
    np.testing.assert_array_equal(got.dbc("an"), jsig.signal_analysis(
        x, fft_n=9, sinpow=sinpow).dbc("an"))
    if case == "am-pm":       # TestSiganal.test_separates_am_from_pm
        assert got.segments_used > 10
        assert got.an_power[20, 0] == pytest.approx(0.01 ** 2, rel=0.05)
        assert got.pn_power[40, 0] == pytest.approx(0.02 ** 2, rel=0.05)
    elif case == "noise":     # test_incoherent_segments_skipped
        assert got.segments_used == 0 and got.segments_skipped > 0
    else:                     # test_two_channel_common_noise_correlates
        assert np.mean(got.pn_corr[1:8]) > 0.8


# ---- weak/eme --------------------------------------------------------

@pytest.mark.parametrize("loc", ["JO89XI", "FN20QR", "RE78IR", "jo89ip"])
def test_locator_roundtrip(loc):
    lat, lon = teme.locator_to_latlon(loc)
    assert (lat, lon) == jeme.locator_to_latlon(loc)
    assert teme.latlon_to_locator(lat, lon) \
        == jeme.latlon_to_locator(lat, lon)


def test_dist_az():
    d, az = teme.dist_az(59.3, 17.9, 40.7, -74.0)
    assert (d, az) == jeme.dist_az(59.3, 17.9, 40.7, -74.0)
    assert d == pytest.approx(6300, rel=0.05) and 280 < az < 310


@pytest.mark.parametrize("dt", [0.0, 86400.0, 3.7e6])
def test_moon(dt):
    for lat, lon in ((59.3, 17.9), (0.0, 0.0), (-33.9, 151.2)):
        got = teme.moon_data(T0 + dt, lat, lon)
        _same_fields(got, jeme.moon_data(T0 + dt, lat, lon))
        assert teme.moon_geocentric(T0 + dt) == jeme.moon_geocentric(T0 + dt)
        assert teme.mutual_doppler(T0 + dt, lat, lon, 33.2, -95.6, 144e6) \
            == jeme.mutual_doppler(T0 + dt, lat, lon, 33.2, -95.6, 144e6)
    md = teme.moon_data(T0, 59.3, 17.9)
    assert 356_000 < md.distance_km < 407_000 and abs(md.doppler_hz) < 450


def test_dx_database(tmp_path):
    """TestEME.test_dx_database and test_dx_report_mutual on both: the
    saved files byte for byte, matches and reports equal."""
    dbs = []
    for mod in (teme, jeme):
        db = mod.DxDatabase()
        db.add("SM5BSZ", locator="JO89IP")
        db.add("W5UN", lat=33.2, lon=-95.6)
        db.add("SM5FRH", locator="JO89XX")
        db.add("SELF", lat=59.3, lon=18.0)
        path = tmp_path / f"dx_{mod.__name__.split('.')[0]}"
        db.save(str(path))
        with open(path, "a") as f:
            f.write("K1JT FN20QI  # comment\n")
        dbs.append((db, mod.DxDatabase.load(str(path)), path.read_bytes()))
    (tdb, tdb2, tbytes), (jdb, jdb2, jbytes) = dbs
    assert tbytes == jbytes
    for q in ("SM5???", "?5", "SM5BSZX", "*"):
        assert [dataclasses.asdict(s) for s in tdb.match(q)] \
            == [dataclasses.asdict(s) for s in jdb.match(q)]
    assert [s.call for s in tdb.match("SM5???")] == ["SM5BSZ", "SM5FRH"]
    assert tdb2.lookup("k1jt").locator == jdb2.lookup("k1jt").locator \
        == "FN20QI"
    r, jr = tdb.report("SELF", T0, 59.3, 18.0), jdb.report("SELF", T0,
                                                          59.3, 18.0)
    assert r.keys() == jr.keys()
    for k in r:
        if dataclasses.is_dataclass(r[k]):
            _same_fields(r[k], jr[k])
        else:
            assert r[k] == jr[k], k
    assert r["window_open"] == (r["own_moon"].elevation > 0)


# ---- modes -----------------------------------------------------------

def test_adtest():
    rng = np.random.default_rng(2)
    x = (0.25 * (rng.normal(size=8192) + 1j * rng.normal(size=8192))
         ).astype(np.complex64) + (0.01 + 0.02j)
    x[100] = 3.99
    got = tmodes.adtest(x, full_scale=4.0)
    _same_fields(got, jmodes.adtest(x, full_scale=4.0))
    _same_fields(tmodes.adtest(_t(x), full_scale=4.0), got)
    assert got.dc_i == pytest.approx(0.01, abs=0.01)
    assert 0 < got.clip_fraction < 1e-3


@pytest.mark.parametrize("nonlinear", [False, True])
def test_txtest(nonlinear):
    fs = 48_000.0
    t = np.arange(1 << 15) / fs
    audio = np.sin(2 * np.pi * 700 * t) + np.sin(2 * np.pi * 1900 * t)
    z = j_ssb_modulate(audio, fs)
    if nonlinear:
        z = z + 0.02 * z * np.abs(z) ** 2
    z = z.astype(np.complex64)
    got = tmodes.txtest(z, fs)
    _same_fields(got, jmodes.txtest(z, fs))
    _same_fields(tmodes.txtest(_t(z), fs), got)
    assert got.occupied_bw_hz < 4000


def test_powtim_and_rate():
    fs = 96_000.0
    x = np.zeros(96_000, np.complex64)
    x[48_000:58_000] = 1.0
    t, p = tmodes.powtim(x, fs, window_s=0.01)
    jt, jp = jmodes.powtim(x, fs, window_s=0.01)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    tt, tp = tmodes.powtim(_t(x), fs, window_s=0.01)
    np.testing.assert_array_equal(tp, p)
    assert (p > 0.5).sum() == pytest.approx(10, abs=1)
    assert tmodes.measure_sample_rate(96_000, 1.0) \
        == jmodes.measure_sample_rate(96_000, 1.0) == 96_000
