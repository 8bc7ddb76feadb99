"""The port's copies of the numpy table functions equal the JAX package's
originals bit for bit, and the port's RxTables/RxState.create equal the
JAX tables and state carried across by linrad_tpu_torch.convert."""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import derive_geometry
from linrad_tpu.ops import blanker as jbl
from linrad_tpu.ops import fft1 as jfft1
from linrad_tpu.ops import mix1 as jmix1
from linrad_tpu.ops import mix2 as jmix2
from linrad_tpu.ops import sellim as jsellim
from linrad_tpu.pipeline.chain import NBState as JNBState
from linrad_tpu.pipeline.chain import RxState as JRxState
from linrad_tpu.pipeline.chain import RxTables as JRxTables
from linrad_tpu_torch import convert, flagship_params
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import blanker as tbl
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.ops import mix2 as tmix2
from linrad_tpu_torch.ops import sellim as tsellim
from linrad_tpu.weak import spur as jspur
from linrad_tpu_torch.pipeline.chain import NBState, RxState, RxTables
from linrad_tpu_torch.weak import spur as tspur

GEOS = ["tiny", "flagship"]


def _params(name):
    return _flagship_params(tiny=name == "tiny")


def _t_geo(p):
    """The port's own Geometry for the JAX package's RxParams p."""
    return t_derive_geometry(convert.params_from_jax(p))


@pytest.mark.parametrize("name", GEOS)
def test_flagship_params_match_entry(name):
    tiny = name == "tiny"
    assert flagship_params(tiny=tiny) == convert.params_from_jax(
        dataclasses.replace(_flagship_params(tiny=tiny),
                            fft1_variant="pallas"))
    assert flagship_params(tiny=tiny, fft1_variant=None) == \
        convert.params_from_jax(_flagship_params(tiny=tiny))
    assert dataclasses.asdict(flagship_params(tiny=tiny, fft1_variant=None)) \
        == dataclasses.asdict(_flagship_params(tiny=tiny))


@pytest.mark.parametrize("name", GEOS)
def test_make_refpulse_bank(name):
    geo = derive_geometry(_params(name))
    rng = np.random.default_rng(0)
    for resp in (np.ones(geo.fft1_size, np.complex128),
                 jfft1.edge_taper_response(geo).astype(np.complex128)
                 * np.exp(1j * rng.uniform(-0.1, 0.1, geo.fft1_size))):
        for a, b in zip(tbl.make_refpulse_bank(resp, 64),
                        jbl.make_refpulse_bank(resp, 64)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", GEOS)
def test_fqwin_weight(name):
    geo = derive_geometry(_params(name))
    m = geo.mix1_size
    d = np.linspace(-m / 2, m / 2, 4 * m + 1)
    np.testing.assert_array_equal(tmix1.fqwin_weight(d, m),
                                  jmix1.fqwin_weight(d, m))


@pytest.mark.parametrize("name", GEOS)
@pytest.mark.parametrize("extra", [{}, {"notches": ((300.0, 50.0),),
                                        "shape": ((-1000.0, -6.0),
                                                  (1000.0, 3.0))},
                                   {"edge_hz": 100.0,
                                    "compensate_fqwin": False}])
def test_bg_filter(name, extra):
    geo = derive_geometry(_params(name))
    tgeo = _t_geo(_params(name))
    np.testing.assert_array_equal(
        tmix2.bg_filter(tgeo, -1500.0, 1500.0, **extra),
        jmix2.bg_filter(geo, -1500.0, 1500.0, **extra))
    freq = np.linspace(-3000.0, 3000.0, 257)
    np.testing.assert_array_equal(
        tmix2._filter_response(freq, tgeo, -800.0, 1200.0, **extra),
        jmix2._filter_response(freq, geo, -800.0, 1200.0, **extra))


@pytest.mark.parametrize("name", GEOS)
def test_edge_taper_and_sellim_limit(name):
    geo = derive_geometry(_params(name))
    tgeo = _t_geo(_params(name))
    np.testing.assert_array_equal(tfft1.edge_taper_response(tgeo),
                                  jfft1.edge_taper_response(geo))
    for level in (8.0, 3.5):
        assert tsellim.sellim_limit(tgeo, level) == \
            jsellim.sellim_limit(geo, level)


def _assert_trees_equal(port: dict, ref: dict):
    assert port, "empty tree"
    for k, v in port.items():
        assert k in ref, k
        assert v.dtype == ref[k].dtype, (k, v.dtype, ref[k].dtype)
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("name", GEOS)
def test_rx_tables_create_equals_converted_jax(name):
    p = _params(name)
    geo = derive_geometry(p)
    ref = convert.flatten(JRxTables.create(geo, p))
    port = convert.flatten(RxTables.create(
        _t_geo(p), convert.params_from_jax(p), "cpu"))
    _assert_trees_equal(port, ref)
    carried = convert.flatten(convert.tables_from_numpy(ref, "cpu"))
    assert carried.keys() == port.keys()
    _assert_trees_equal(carried, ref)


@pytest.mark.parametrize("name", GEOS)
def test_rx_state_create_and_round_trip(name):
    geo = derive_geometry(_params(name))
    ref = convert.flatten(JRxState.create(geo))
    port = convert.state_to_numpy(RxState.create(_t_geo(_params(name)),
                                                 "cpu"))
    _assert_trees_equal(port, ref)
    back = convert.state_to_numpy(convert.state_from_numpy(ref, "cpu"))
    assert back.keys() == port.keys()
    _assert_trees_equal(back, ref)
    st = convert.state_from_numpy(ref, "cpu")
    assert st.mix1.phase_idx.shape == () and st.blanker.noise_floor.shape == ()


def test_wideband_off_leaves_wide_fields_none():
    p = dataclasses.replace(_params("tiny"), second_fft_enable=False,
                            blanker_enable=False)
    geo = derive_geometry(p)
    tables = convert.tables_from_numpy(
        convert.flatten(JRxTables.create(geo, p)), "cpu")
    state = convert.state_from_numpy(convert.flatten(JRxState.create(geo)),
                                     "cpu")
    assert tables.fft2 is None and tables.blanker is None
    assert tables.timf2_syn is None
    assert state.sellim is None and state.blanker is None
    assert isinstance(state.fft1.tail, torch.Tensor)


# ---- the tables of mixer mode 2 and of the spur canceller ------------

@pytest.mark.parametrize("name", GEOS)
@pytest.mark.parametrize("extra", [{}, {"mix2_reduction_n": 2},
                                   {"filter_low_hz": 200.0,
                                    "filter_high_hz": 2400.0,
                                    "notches": ((900.0, 60.0),)}])
def test_basebraw_fir(name, extra):
    p = dataclasses.replace(_params(name), mixer_mode=2, **extra)
    tp = convert.params_from_jax(p)
    ref = jmix2.basebraw_fir(derive_geometry(p), p)
    fir = tmix2.basebraw_fir(t_derive_geometry(tp), tp)
    assert fir.dtype == np.complex64 and fir.shape[0] % 2 == 1
    np.testing.assert_array_equal(fir, ref)
    np.testing.assert_array_equal(
        tmix2.basebraw_fir(t_derive_geometry(tp), tp, threshold=1e-4),
        jmix2.basebraw_fir(derive_geometry(p), p, threshold=1e-4))


@pytest.mark.parametrize("size,sinpow", [(512, 2), (4096, 2), (256, 1),
                                         (1024, 4)])
def test_window_template_and_table(size, sinpow):
    np.testing.assert_array_equal(tspur.window_template(size, sinpow),
                                  jspur.window_template(size, sinpow))
    table = tspur.window_template_table(size, sinpow)
    assert table.shape == (2 * (tspur.TEMPLATE_HALF + 1) * tspur.TEMPLATE_OS
                           + 1,)
    np.testing.assert_array_equal(table,
                                  jspur.window_template_table(size, sinpow))
    np.testing.assert_array_equal(
        tspur.window_template_table(size, sinpow, os=8),
        jspur.window_template_table(size, sinpow, os=8))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 11])
def test_smooth_kernel(k):
    kern = tspur._smooth_kernel(k)
    np.testing.assert_array_equal(kern, jspur._smooth_kernel(k))
    assert kern.shape == (k,) and abs(kern.sum() - 1.0) < 1e-12
    assert (tspur.MAX_SPURS, tspur.TEMPLATE_HALF, tspur.TEMPLATE_OS,
            tspur.SMOOTH_LEN, tspur.SMOOTH_KIND) == (
        jspur.MAX_SPURS, jspur.TEMPLATE_HALF, jspur.TEMPLATE_OS,
        jspur.SMOOTH_LEN, jspur.SMOOTH_KIND)


OPTION_TABLES = {
    "spur": dict(spur_enable=True),
    "spur-no-fft2": dict(spur_enable=True, second_fft_enable=False,
                         blanker_enable=False),
    "mixer2": dict(mixer_mode=2),
    "real": dict(input_mode=0),
}


@pytest.mark.parametrize("option", list(OPTION_TABLES))
def test_option_tables_and_state_equal_converted_jax(option):
    """RxTables/RxState.create with each option's extra fields
    (spur_template, spur.*, mix2.fir, mix2_fir.carry, the float32 real
    fft1.tail, iq_corr) equal the JAX ones, and convert carries them."""
    p = dataclasses.replace(_params("tiny"), **OPTION_TABLES[option])
    tp = convert.params_from_jax(p)
    geo, tgeo = derive_geometry(p), t_derive_geometry(tp)
    rng = np.random.default_rng(5)
    cal = {"iq_corr": (rng.normal(size=256) + 1j * rng.normal(size=256)
                       ).astype(np.complex64)} if option == "real" else None
    jt = JRxTables.create(geo, p, cal)
    ref = convert.flatten(jt)
    port = convert.flatten(RxTables.create(tgeo, tp, "cpu", cal))
    assert port.keys() == ref.keys()
    _assert_trees_equal(port, ref)
    _assert_trees_equal(convert.flatten(convert.tables_from_numpy(ref, "cpu")),
                        ref)
    fir_len = int(jt.mix2.fir.shape[0]) if jt.mix2.fir is not None else 0
    sref = convert.flatten(JRxState.create(geo, spur=p.spur_enable,
                                           fir_len=fir_len))
    sport = convert.state_to_numpy(RxState.create(
        tgeo, "cpu", spur=p.spur_enable, fir_len=fir_len))
    assert sport.keys() == sref.keys()
    _assert_trees_equal(sport, sref)
    _assert_trees_equal(
        convert.state_to_numpy(convert.state_from_numpy(sref, "cpu")), sref)
    expect = {"spur": ("spur_template", "spur.bins"),
              "spur-no-fft2": ("spur_template", "spur.frac"),
              "mixer2": ("mix2.fir", "mix2_fir.carry"),
              "real": ("fft1.iq_corr", "squelch.gate")}[option]
    assert expect[0] in port and expect[1] in sport


@pytest.mark.parametrize("k", [1, 3])
def test_nbstate_stacked_equals_converted_jax(k):
    p = dataclasses.replace(_params("tiny"), mixer_mode=2)
    geo, tgeo = derive_geometry(p), _t_geo(p)
    ref = convert.flatten(JNBState.create_stacked(geo, k, fir_len=9))
    port = convert.state_to_numpy(NBState.create_stacked(tgeo, k, "cpu",
                                                         fir_len=9))
    assert port.keys() == ref.keys()
    _assert_trees_equal(port, ref)
    back = convert.nbstate_from_numpy(ref, "cpu")
    _assert_trees_equal(convert.state_to_numpy(back), ref)
    assert back.mix1.phase_idx.shape == (k,)
    assert back.mix2_fir.carry.shape == (k, 8, 1)
    assert back.squelch.gate.shape == (k,)
