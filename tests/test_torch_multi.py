"""The multi-sub-receiver step: K independently tuned narrowband tails
over one wideband front end (make_multi_rx_step, NBState, MultiReceiver).

- The port's MultiReceiver against the JAX package's at K = 3 over 8 steps
  at _flagship_params(tiny=True), from the same tables and states carried
  across by linrad_tpu_torch.convert; the JAX step is ``jax.vmap`` over its
  tail, the port's tail runs once on tensors with a leading K axis.  Bars
  as tests/test_torch_chain.py.
- Row k of the multi step against the port's single-receiver step tuned to
  the same bin, under every option that changes the tail (atol 1e-5, as
  tests/test_chain.py holds the JAX package's).
- One code path: the number of device operations per step that
  ``torch.profiler`` counts is the same at K = 1 and K = 3.
"""

import dataclasses
from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu.io.siggen import Tone, tones_iq
from linrad_tpu.pipeline.receiver import MultiReceiver as JaxMultiReceiver
from linrad_tpu_torch import Demod, RxParams, convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.pipeline.chain import (NBState, RxState, RxTables,
                                             make_multi_rx_step,
                                             make_rx_step)
from linrad_tpu_torch.pipeline.receiver import MultiReceiver, Receiver

STEPS = 8
K = 3
TUNE_HZ = [12_345.6, -7_000.0, 30_100.0]
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


def _input(geo, steps=STEPS, channels=1) -> np.ndarray:
    """Gaussian noise, a strong carrier, 12 impulses per step, and a tone
    300 Hz above each dial frequency (strengths 1, 2, 3: below the level
    that sellim calls strong, so that the front end's protected passband,
    which follows sub-receiver 0, protects nothing and a single receiver
    on any of the dials sees the same wideband spectra)."""
    rng = np.random.default_rng(7)
    n = steps * geo.samples_per_step
    t = np.arange(n) / geo.timf1_sampling_speed
    x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         + 100.0 * np.exp(2j * np.pi * -20_000.0 * t))
    for k, f in enumerate(TUNE_HZ):
        x = x + 1.0 * (k + 1) * np.exp(2j * np.pi * (f + 300.0) * t)
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=12))
    x = x.astype(np.complex64)[:, None]
    if channels == 2:
        x = x * np.array([0.8, 0.6j], np.complex64)[None, :] \
            + (rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
               ).astype(np.complex64)
    return x


# ---- MultiReceiver against MultiReceiver -----------------------------

CONFIGS = {
    "pallas": dict(fft1_variant="pallas"),
    # every stage the sub-receivers of the smoke run's phase 8 go through
    "spur-squelch-expander": dict(fft1_variant="xla", spur_enable=True,
                                  squelch_enable=True, squelch_ratio=12.0,
                                  expander_exponent=2.0),
    "mixer2-no-fft2": dict(mixer_mode=2, second_fft_enable=False,
                           blanker_enable=False, agc_hang_ms=5.0),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    p = dataclasses.replace(_TINY, **CONFIGS[request.param])
    jrx = JaxMultiReceiver(p, K)
    trx = MultiReceiver(convert.params_from_jax(p), K, device="cpu")
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    trx.nbs = convert.nbstate_from_numpy(convert.flatten(jrx.nbs), "cpu")
    for k, f in enumerate(TUNE_HZ):
        jrx.tune_subch(k, f)
        trx.tune_subch(k, f)
    np.testing.assert_array_equal(trx._tune_bins.numpy(), jrx._tune_bins)
    iq = _input(jrx.geo)
    j_out = list(jrx.run(iq))
    t_out = list(trx.run(iq))
    assert len(j_out) == len(t_out) == STEPS
    return dict(name=request.param, p=p, jrx=jrx, trx=trx, j_out=j_out,
                t_out=t_out)


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
    if field in ("audio", "baseb", "agc_gain"):
        assert tv[0].shape == (K, runs["trx"].geo.baseband_samples_per_step,
                               1)
    if field in ("blanker_fitted", "blanker_cleared"):
        assert [int(v) for v in tv] == [int(v) for v in jv]
        return
    t_arr = np.stack([v.numpy() for v in tv])
    j_arr = np.stack([np.asarray(v) for v in jv])
    if field == "liminfo":
        np.testing.assert_array_equal(np.sign(t_arr), np.sign(j_arr))
    bar = BARS.get(field, OTHER_BAR)
    if field in ("audio", "baseb", "agc_gain"):
        # each sub-receiver against its own scale
        for k in range(K):
            assert _max_rel(t_arr[:, k], j_arr[:, k]) <= bar, (name, k)
    else:
        assert _max_rel(t_arr, j_arr) <= bar, name


def test_final_states(runs):
    """Wideband state and the stacked narrowband state after 8 steps:
    integers exact, floats <= 1e-4; the narrowband fields of the wideband
    RxState pass through untouched."""
    jrx, trx = runs["jrx"], runs["trx"]
    for ref, port in ((convert.flatten(jrx.state),
                       convert.state_to_numpy(trx.state)),
                      (convert.flatten(jrx.nbs),
                       convert.state_to_numpy(trx.nbs))):
        assert set(port) == set(ref)
        for k, v in port.items():
            assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
            if v.dtype.kind in "iub":
                np.testing.assert_array_equal(v, ref[k], err_msg=k)
            else:
                assert _max_rel(v, ref[k]) <= OTHER_BAR, k
    assert trx.nbs.mix1.phase_idx.shape == (K,)
    assert float(trx.state.mix1.ola_carry.abs().max()) == 0.0
    assert float(trx.nbs.mix1.ola_carry.abs().max()) > 0.0


def test_comparison_not_vacuous(runs):
    p, t_out, trx = runs["p"], runs["t_out"], runs["trx"]
    audio = torch.cat([o.audio for o in t_out], dim=1)       # (K, S, 1)
    for k in range(K):
        assert float(audio[k].abs().max()) > 0
    assert not torch.equal(audio[0], audio[1])
    if p.second_fft_enable:
        assert max(int(o.blanker_fitted) for o in t_out) > 0
    if p.squelch_enable:
        assert trx.nbs.squelch.gate.shape == (K,)
    if p.mixer_mode == 2:
        assert trx.nbs.mix2_fir.carry.shape[0] == K


# ---- row k of the multi step against the single-receiver step --------

ROW_OPTIONS = {
    "ssb-agc": dict(),
    "no-agc-none": dict(agc_enable=False, demod=Demod.NONE),
    "am": dict(demod=Demod.AM),
    "fm-deemph": dict(demod=Demod.FM, fm_deemphasis_us=75.0),
    "coherent2": dict(demod=Demod.COHERENT, coherent_mode=2),
    "coherent1": dict(demod=Demod.COHERENT, coherent_mode=1),
    "hang-expander-squelch": dict(agc_hang_ms=5.0, expander_exponent=2.0,
                                  squelch_enable=True, squelch_ratio=12.0),
    "mixer2-coherent": dict(mixer_mode=2, mix2_reduction_n=1,
                            demod=Demod.COHERENT),
    "pol-adapt": dict(rx_rf_channels=2, pol_adapt_enable=True),
    "pol-adapt-coherent": dict(rx_rf_channels=2, pol_adapt_enable=True,
                               demod=Demod.COHERENT),
    "no-fft2": dict(second_fft_enable=False, blanker_enable=False),
}


def _steps_for(p, k):
    geo = t_derive_geometry(p)
    tables = RxTables.create(geo, p, "cpu")
    fir = tables.mix2.fir
    fir_len = int(fir.shape[0]) if fir is not None else 0
    ac = None
    if p.demod == Demod.COHERENT and p.coherent_mode == 1:
        ac = 2 * (1 if p.pol_adapt_enable else geo.channels)
    state = RxState.create(geo, "cpu", pol=p.pol_adapt_enable,
                           fir_len=fir_len, audio_channels=ac)
    one = NBState.from_rx(state)
    nbs = type(one)(**{
        name: None if sub is None else type(sub)(**{
            f.name: getattr(sub, f.name)[None].repeat(
                (k,) + (1,) * getattr(sub, f.name).dim())
            for f in dataclasses.fields(sub)})
        for name, sub in one.fields().items()})
    return geo, tables, state, nbs


@pytest.mark.parametrize("option", list(ROW_OPTIONS))
def test_multi_row_equals_single_step(option):
    """4 steps: sub-receiver k of the K = 3 step equals the single step
    tuned to bin k (baseb, audio, gain within 1e-5), and its row of the
    stacked state equals the single receiver's state."""
    p = dataclasses.replace(convert.params_from_jax(_TINY),
                            fft1_variant="xla", **ROW_OPTIONS[option])
    geo, tables, state0, nbs = _steps_for(p, K)
    n = geo.fftx_size
    bins = torch.tensor([int(round(f / geo.timf1_sampling_speed * n)) % n
                         for f in TUNE_HZ])
    iq = _input(geo, 4, geo.channels)
    s = geo.samples_per_step
    mstep = make_multi_rx_step(geo, p)
    sstep = make_rx_step(geo, p)
    state = state0
    multi = []
    for i in range(4):
        (state, nbs), out = mstep(tables, state, nbs,
                                  torch.from_numpy(iq[i * s:(i + 1) * s]),
                                  bins)
        multi.append(out)
    for k in range(K):
        sstate = state0
        for i in range(4):
            sstate, out = sstep(tables, sstate,
                                torch.from_numpy(iq[i * s:(i + 1) * s]),
                                bins[k])
            for f in ("baseb", "audio", "agc_gain"):
                a, b = getattr(multi[i], f)[k], getattr(out, f)
                assert a.shape == b.shape, (f, a.shape, b.shape)
                scale = max(float(b.abs().max()), 1.0)
                assert float((a - b).abs().max()) <= 1e-5 * scale, (f, k, i)
            if k == 0:      # the front end is tuned by sub-receiver 0
                for f in ("fft1_power", "fft2_power", "liminfo"):
                    a, b = getattr(multi[i], f), getattr(out, f)
                    assert (a is None and b is None) or torch.equal(a, b), f
        row = {name: v[k] for name, v in
               convert.state_to_numpy(nbs).items()}
        single = convert.state_to_numpy(NBState.from_rx(sstate))
        assert set(row) == set(single)
        for name, v in row.items():
            assert v.shape == single[name].shape, name
            if v.dtype.kind in "iub":
                np.testing.assert_array_equal(v, single[name], err_msg=name)
            else:
                assert _max_rel(v, single[name]) <= 1e-5, name


def test_per_frame_tune_bins():
    """tune_bins (K, n): per-frame bins for each sub-receiver; constant
    rows give what (K,) gives, and a row that moves differs."""
    p = dataclasses.replace(convert.params_from_jax(_TINY),
                            fft1_variant="xla")
    geo, tables, state, nbs = _steps_for(p, 2)
    n_fr = geo.fftx_frames_per_step
    block = torch.from_numpy(_input(geo, 1))
    step = make_multi_rx_step(geo, p)
    bins = torch.tensor([66, 300])
    _st, flat = step(tables, state, nbs, block, bins)
    _st, framed = step(tables, state, nbs, block,
                       bins[:, None].expand(2, n_fr).contiguous())
    assert torch.equal(flat.baseb, framed.baseb)
    moving = bins[:, None].repeat(1, n_fr)
    moving[1, n_fr // 2:] += 1
    (_s, nbs2), moved = step(tables, state, nbs, block, moving)
    assert torch.equal(moved.baseb[0], flat.baseb[0])
    assert not torch.equal(moved.baseb[1], flat.baseb[1])
    hop = geo.fftx_new_points
    expect = (66 * hop * n_fr) % geo.fftx_size, \
        (300 * hop * n_fr + hop * (n_fr - n_fr // 2)) % geo.fftx_size
    assert tuple(nbs2.mix1.phase_idx.tolist()) == expect


def test_multi_subreceiver():
    """The JAX package's own test (tests/test_chain.py) on the port: each
    sub-receiver equals a single receiver tuned to the same bin, and its
    tone comes out clean."""
    p = RxParams(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                 agc_enable=False, demod=Demod.NONE)
    geo, tables, state0, nbs = _steps_for(p, 3)
    freqs = [10_000.0, 12_000.0, 15_500.0]
    n = geo.fftx_size
    fs = geo.timf1_sampling_speed
    bins = torch.tensor([int(round(f / fs * n)) % n for f in freqs])
    centers = [int(b) * fs / n for b in bins]  # quantised tuning
    iq = tones_iq(geo.rx_ad_speed, geo.samples_per_step * 4,
                  [Tone(c + 300.0) for c in centers])[:, None]
    mstep = make_multi_rx_step(geo, p)
    sstep = make_rx_step(geo, p)
    s = geo.samples_per_step
    state = state0
    multi = []
    for i in range(4):
        (state, nbs), out = mstep(tables, state, nbs,
                                  torch.from_numpy(iq[i * s:(i + 1) * s]),
                                  bins)
        multi.append(out.baseb.numpy())
    multi = np.concatenate(multi, axis=1)  # (K, S, C)
    for k in range(len(freqs)):
        sstate = state0
        single = []
        for i in range(4):
            sstate, out = sstep(tables, sstate,
                                torch.from_numpy(iq[i * s:(i + 1) * s]),
                                bins[k])
            single.append(out.baseb.numpy())
        np.testing.assert_allclose(multi[k], np.concatenate(single),
                                   atol=1e-5)
        z = multi[k][multi.shape[1] // 3:, 0]
        t = np.arange(len(z)) / geo.baseband_sampling_speed
        ref = np.exp(2j * np.pi * 300.0 * t)
        resid = z - np.vdot(ref, z) / len(z) * ref
        snr = 10 * np.log10(np.vdot(z, z).real
                            / max(np.vdot(resid, resid).real, 1e-30))
        assert snr > 60.0, (k, snr)


# ---- one code path: operations per step do not grow with K -----------

def _ops_per_step(p, k) -> Counter:
    rx = MultiReceiver(p, k, device="cpu")
    for i in range(k):
        rx.tune_subch(i, TUNE_HZ[i % 3] + 50.0 * i)
    iq = _input(rx.geo, 3)
    s = rx.geo.samples_per_step
    rx.process_block(iq[:s])
    rx.process_block(iq[s:2 * s])
    block = torch.from_numpy(iq[2 * s:])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rx.process_block(block)
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.key.startswith("aten::")})


@pytest.mark.parametrize("option", ["flagship", "spur-squelch-expander",
                                    "mixer2"])
def test_operation_count_does_not_grow_with_k(option):
    """torch.profiler's count of aten operations in one step at K = 1, 3
    and 6.  K = 3 and K = 6 run exactly the same operations.  K = 1 may
    differ by a few layout operations: where a reshape or ``contiguous``
    of a tensor whose K axis has length 1 is a view, the same call on
    K > 1 rows copies."""
    extra = {"flagship": {}, "mixer2": dict(mixer_mode=2),
             "spur-squelch-expander": dict(spur_enable=True,
                                           squelch_enable=True,
                                           expander_exponent=2.0)}[option]
    p = dataclasses.replace(convert.params_from_jax(_TINY),
                            fft1_variant="xla", **extra)
    ops = {k: _ops_per_step(p, k) for k in (1, 3, 6)}
    assert ops[3] == ops[6]
    total = {k: sum(v.values()) for k, v in ops.items()}
    assert total[3] == total[6]
    differ = {name: (ops[1][name], ops[3][name])
              for name in set(ops[1]) | set(ops[3])
              if ops[1][name] != ops[3][name]}
    # measured: 2 to 12 operations of about 9,800 differ, all of them
    # views, copies or allocations
    layout = {"aten::copy_", "aten::clone", "aten::contiguous",
              "aten::empty_like", "aten::empty", "aten::_reshape_alias",
              "aten::view", "aten::reshape", "aten::_unsafe_view",
              "aten::empty_strided", "aten::resolve_conj", "aten::as_strided",
              "aten::expand", "aten::_to_copy", "aten::to", "aten::narrow",
              "aten::slice"}
    assert set(differ) <= layout, differ
    assert abs(total[3] - total[1]) <= 0.005 * total[1], (total, differ)


def test_multi_receiver_runs_real_input():
    p = dataclasses.replace(convert.params_from_jax(_TINY), input_mode=0)
    rx = MultiReceiver(p, 2, device="cpu")
    rx.tune_subch(0, 5_000.0)
    rx.tune_subch(1, 9_000.0)
    s = 2 * rx.geo.samples_per_step
    rng = np.random.default_rng(8)
    outs = list(rx.run(rng.normal(size=3 * s + 5).astype(np.float32)))
    assert len(outs) == 3
    assert outs[-1].audio.shape == (2, rx.geo.baseband_samples_per_step, 1)
    assert torch.isfinite(outs[-1].audio).all()
