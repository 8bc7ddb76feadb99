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
from linrad_tpu.pipeline.chain import RxState as JRxState
from linrad_tpu.pipeline.chain import RxTables as JRxTables
from linrad_tpu_torch import convert, flagship_params
from linrad_tpu_torch.ops import blanker as tbl
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.ops import mix2 as tmix2
from linrad_tpu_torch.ops import sellim as tsellim
from linrad_tpu_torch.pipeline.chain import RxState, RxTables

GEOS = ["tiny", "flagship"]


def _params(name):
    return _flagship_params(tiny=name == "tiny")


@pytest.mark.parametrize("name", GEOS)
def test_flagship_params_match_entry(name):
    tiny = name == "tiny"
    assert flagship_params(tiny=tiny) == dataclasses.replace(
        _flagship_params(tiny=tiny), fft1_variant="pallas")
    assert flagship_params(tiny=tiny, fft1_variant=None) == \
        _flagship_params(tiny=tiny)


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
    np.testing.assert_array_equal(
        tmix2.bg_filter(geo, -1500.0, 1500.0, **extra),
        jmix2.bg_filter(geo, -1500.0, 1500.0, **extra))
    freq = np.linspace(-3000.0, 3000.0, 257)
    np.testing.assert_array_equal(
        tmix2._filter_response(freq, geo, -800.0, 1200.0, **extra),
        jmix2._filter_response(freq, geo, -800.0, 1200.0, **extra))


@pytest.mark.parametrize("name", GEOS)
def test_edge_taper_and_sellim_limit(name):
    geo = derive_geometry(_params(name))
    np.testing.assert_array_equal(tfft1.edge_taper_response(geo),
                                  jfft1.edge_taper_response(geo))
    for level in (8.0, 3.5):
        assert tsellim.sellim_limit(geo, level) == \
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
    port = convert.flatten(RxTables.create(geo, p, "cpu"))
    _assert_trees_equal(port, ref)
    carried = convert.flatten(convert.tables_from_numpy(ref, "cpu"))
    assert carried.keys() == port.keys()
    _assert_trees_equal(carried, ref)


@pytest.mark.parametrize("name", GEOS)
def test_rx_state_create_and_round_trip(name):
    geo = derive_geometry(_params(name))
    ref = convert.flatten(JRxState.create(geo))
    port = convert.state_to_numpy(RxState.create(geo, "cpu"))
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
