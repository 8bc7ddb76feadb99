"""The receivers that replay their step from CUDA graphs (Receiver,
MultiReceiver and the one-device sharded classes, ``graphed=``), held on
the CPU, where ``graphed=True`` runs the graphs' bodies eagerly: the
static buffers, the tuning written into each structure's static tensors,
the choice of graph by tuning structure, the state and tables setters and
the copies of the outputs all run as on a card, without the capture.

- Against the JAX package's Receiver and MultiReceiver on the CPU, made
  as tests/test_torch_eme.py makes them (the port's tables and state
  assigned from the JAX receiver's through the graphed receiver's
  setters): the tiny flagship over 6 steps; the tiny EME coherent
  configuration over 10 steps through the AFC's lock (AFC trajectory
  exact, both structures' graphs run); MultiReceiver at K = 3; the spur
  path with ``control.spur_scan_interval = 2``.  Bars as
  tests/test_torch_eme.py: blanker counts and the liminfo sign pattern
  exact, liminfo <= 1e-5, audio <= 2.3e-4, fft2_power <= 1e-6, every
  other float field and the final state <= 1e-4; AFC status and frame
  bins exact, frequency within 1e-3 bin, (frac, slope) within 1e-5.
- The port alone: save and load mid-stream, resumed bit-equal to a
  graphed run streamed straight; a step's outputs unchanged by the next;
  ``rx.tables = ...`` after construction taking effect; a state or tables
  of another structure refused; the per-frame AFC structure; the sharded
  classes over ``["cpu"] * 2`` graphed against eager, bit for bit; and
  ``graphed=True`` refused where no graph can be made (a DistGroup,
  several devices).

Each JAX run is made once, in a module fixture.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from __graft_entry__ import _flagship_params
from linrad_tpu import RxMode, preset
from linrad_tpu.pipeline.receiver import MultiReceiver as JaxMultiReceiver
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu_torch import RxParams as TRxParams
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.parallel import (DistGroup, LocalGroup,
                                       ShardedBatchRunner,
                                       ShardedMultiReceiver,
                                       ShardedReceiver)
from linrad_tpu_torch.pipeline.batch import tensor_leaves
from linrad_tpu_torch.pipeline.chain import RxState, RxTables
from linrad_tpu_torch.pipeline.checkpoint import load_receiver, save_receiver
from linrad_tpu_torch.pipeline.receiver import (MultiReceiver, Receiver,
                                                tuning_structures)

FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
WIDE_ONLY = ("fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
             "noise_floor")
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
OTHER_BAR = 1e-4
FP32 = 1e-5

TUNE_HZ = 12_345.6
EME_TUNE_HZ = 1_000.0
EME_STEPS = 10
FLAGSHIP_STEPS = 6
MULTI_STEPS = 8
MULTI_DIALS = [12_345.6, -7_000.0, 30_100.0]
SPUR_STEPS = 10
SPUR_HZ = -19_000.0
POL_TRUE = np.array([0.8, 0.6j])
EME_TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
                max_pulses_per_block=8)


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _eme_params(**kw):
    return preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
                  pol_adapt_enable=True, **EME_TINY, **kw)


def _flagship_input(geo, steps: int, seed: int = 0,
                    spur_hz: float | None = None) -> np.ndarray:
    """Gaussian noise, a weak tone 300 Hz above the dial, a strong carrier
    (at ``spur_hz`` when given, the spur the manager finds) and 12
    impulses per step."""
    rng = np.random.default_rng(seed)
    n = steps * geo.samples_per_step
    t = np.arange(n) / geo.timf1_sampling_speed
    carrier_hz = -20_000.0 if spur_hz is None else spur_hz
    x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         + 100.0 * np.exp(2j * np.pi * carrier_hz * t)
         + 2.0 * np.exp(2j * np.pi * (TUNE_HZ + 300.0) * t))
    for tone, f in enumerate(MULTI_DIALS[1:]):
        x = x + (tone + 2.0) * np.exp(2j * np.pi * (f + 300.0) * t)
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=12))
    return x.astype(np.complex64)[:, None]


def _eme_input(geo, steps: int, seed: int = 3) -> np.ndarray:
    """tests/test_torch_eme.py's EME input: a keyed carrier drifting 0.05
    Hz/s split 0.8 : 0.6j over the two channels, noise, a strong carrier
    and 12 impulses per step."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 3).astype(np.float64)
    phase = 2 * np.pi * np.cumsum(EME_TUNE_HZ + 5.0 + 0.05 * t) / fs
    x = (key * np.exp(1j * phase))[:, None] * POL_TRUE[None, :]
    x = x + rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    x = x + (100.0 * np.exp(2j * np.pi * -15_000.0 * t + 0.3j)[:, None]
             * np.array([1.0, 0.5]))
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, 12)
        x[pos] += (300.0 * np.exp(2j * np.pi * rng.uniform(size=(12, 1)))
                   * np.array([1.0, 0.7]))
    return x.astype(np.complex64)


def _graphed_from_jax(jrx, device="cpu", **kw) -> Receiver:
    """A graphed port Receiver with the JAX receiver's tables and state,
    assigned after construction through the graphed setters."""
    trx = Receiver(convert.params_from_jax(jrx.params), device=device,
                   graphed=True, **kw)
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           device)
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), device)
    return trx


def _afc_point(rx) -> tuple:
    def arr(v):
        return None if v is None else np.array(
            v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    afc = rx.afc
    return (afc.status if afc else None, afc.freq_hz if afc else None,
            arr(rx._tune_bin), arr(rx._tune_frac), arr(rx._tune_slope))


def _both(jrx, trx, iq, slots: bool = False) -> dict:
    """Both receivers over iq: outputs, AFC points and spur slot bins per
    step."""
    run = {"j": [], "t": [], "j_afc": [], "t_afc": [], "j_bins": [],
           "t_bins": []}
    for side, rx in (("j", jrx), ("t", trx)):
        for out in rx.run(iq):
            run[side].append(out)
            run[side + "_afc"].append(_afc_point(rx))
            if slots:
                bins = rx.state.spur.bins
                run[side + "_bins"].append(
                    bins.numpy().copy() if isinstance(bins, torch.Tensor)
                    else np.asarray(bins).copy())
    return run


def _check_field(run: dict, p, field: str) -> None:
    jv = [getattr(o, field) for o in run["j"]]
    tv = [getattr(o, field) for o in run["t"]]
    assert len(jv) == len(tv) > 0
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
    assert _max_rel(t_arr, j_arr) <= BARS.get(field, OTHER_BAR), field


def _check_state(ref: dict, port: dict) -> None:
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= OTHER_BAR, k


def _equal_outputs(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x, y), f.name


# ---- against the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    p = _flagship_params(tiny=True)
    jrx = JaxReceiver(p)
    trx = _graphed_from_jax(jrx)
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    run = _both(jrx, trx, _flagship_input(jrx.geo, FLAGSHIP_STEPS))
    return dict(run, p=p, jrx=jrx, trx=trx)


@pytest.mark.parametrize("field", FIELDS)
def test_flagship_against_jax(flagship, field):
    _check_field(flagship, flagship["p"], field)


def test_flagship_final_state_and_graph(flagship):
    trx = flagship["trx"]
    _check_state(convert.flatten(flagship["jrx"].state),
                 convert.state_to_numpy(trx.state))
    assert trx.graphed and list(trx.graphs) == ["bin"]
    assert trx.graphs["bin"].replays == FLAGSHIP_STEPS
    assert trx.graphs["bin"].graph is None       # the CPU: no capture


@pytest.fixture(scope="module")
def eme():
    p = _eme_params(fft1_variant="pallas")
    jrx = JaxReceiver(p)
    trx = _graphed_from_jax(jrx)
    jrx.tune(EME_TUNE_HZ)
    trx.tune(EME_TUNE_HZ)
    run = _both(jrx, trx, _eme_input(jrx.geo, EME_STEPS))
    return dict(run, p=p, jrx=jrx, trx=trx)


def test_eme_afc_trajectory(eme):
    geo = eme["jrx"].geo
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    statuses = [a[0] for a in eme["j_afc"]]
    assert 2 in statuses and 3 in statuses, statuses
    for i, (j, t) in enumerate(zip(eme["j_afc"], eme["t_afc"])):
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
def test_eme_against_jax(eme, field):
    _check_field(eme, eme["p"], field)


def test_eme_every_structure_ran(eme):
    """One graph per structure the coherent AFC reaches: the one bin
    before the lock, per-frame (bins, frac, slope) after; each replayed,
    and together once per step."""
    trx = eme["trx"]
    assert set(trx.graphs) == {"bin", "coherent"}
    replays = {k: g.replays for k, g in trx.graphs.items()}
    assert min(replays.values()) >= 1, replays
    assert sum(replays.values()) == EME_STEPS
    assert trx.control.host_reads == EME_STEPS
    _check_state(convert.flatten(eme["jrx"].state),
                 convert.state_to_numpy(trx.state))


@pytest.fixture(scope="module")
def multi():
    p = _flagship_params(tiny=True)
    k = len(MULTI_DIALS)
    jrx = JaxMultiReceiver(p, k)
    trx = MultiReceiver(convert.params_from_jax(p), k, device="cpu",
                        graphed=True)
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    trx.nbs = convert.nbstate_from_numpy(convert.flatten(jrx.nbs), "cpu")
    for i, f in enumerate(MULTI_DIALS):
        jrx.tune_subch(i, f)
        trx.tune_subch(i, f)
    iq = _flagship_input(jrx.geo, MULTI_STEPS, seed=7)
    return dict(j=list(jrx.run(iq)), t=list(trx.run(iq)), p=p, jrx=jrx,
                trx=trx)


@pytest.mark.parametrize("field", FIELDS)
def test_multi_against_jax(multi, field):
    _check_field(multi, multi["p"], field)


def test_multi_final_states(multi):
    jrx, trx = multi["jrx"], multi["trx"]
    _check_state(convert.flatten(jrx.state),
                 convert.state_to_numpy(trx.state))
    _check_state(convert.flatten(jrx.nbs), convert.state_to_numpy(trx.nbs))
    assert list(trx.graphs) == ["bins"]
    assert trx.graphs["bins"].replays == MULTI_STEPS
    # tune_subch writes into the tensor the graph reads
    assert trx.graphs["bins"].args[0] is trx._tune_bins


@pytest.fixture(scope="module")
def spur():
    p = dataclasses.replace(_flagship_params(tiny=True),
                            fft1_variant="pallas", spur_enable=True)
    jrx = JaxReceiver(p)
    trx = _graphed_from_jax(jrx)
    jrx.control.spur_scan_interval = trx.control.spur_scan_interval = 2
    jrx.tune(TUNE_HZ)
    trx.tune(TUNE_HZ)
    run = _both(jrx, trx, _flagship_input(jrx.geo, SPUR_STEPS, seed=6,
                                          spur_hz=SPUR_HZ), slots=True)
    return dict(run, p=p, jrx=jrx, trx=trx)


def test_spur_slots_exact_per_step(spur):
    """The manager's new slots reach the graph's state through the state
    setter: the slot bins equal JAX's after every step, and a slot holds
    the carrier once the first scan has run."""
    geo = spur["jrx"].geo
    for i, (j, t) in enumerate(zip(spur["j_bins"], spur["t_bins"])):
        np.testing.assert_array_equal(t, j, err_msg=f"step {i}")
    carrier = int(round(SPUR_HZ / geo.timf1_sampling_speed
                        * geo.fftx_size)) % geo.fftx_size
    assert (spur["t_bins"][0] < 0).all()
    assert any(abs(b - carrier) <= 1 for b in spur["t_bins"][-1] if b >= 0)
    assert spur["trx"].control.host_reads == 6 * (SPUR_STEPS // 2)


@pytest.mark.parametrize("field", FIELDS)
def test_spur_against_jax(spur, field):
    _check_field(spur, spur["p"], field)


# ---- the port alone ------------------------------------------------------

@pytest.fixture(scope="module")
def eme_port():
    """The tiny EME configuration through the port's graphed Receiver
    alone, its own tables and state, streamed straight."""
    p = convert.params_from_jax(_eme_params(fft1_variant="pallas"))
    rx = Receiver(p, device="cpu", graphed=True)
    rx.tune(EME_TUNE_HZ)
    iq = _eme_input(rx.geo, EME_STEPS)
    outs, status = [], []
    for out in rx.run(iq):
        outs.append(out)
        status.append(rx.afc.status)
    return dict(p=p, iq=iq, outs=outs, status=status)


def test_resume_mid_stream_bit_equal(eme_port, tmp_path):
    """Saved by a graphed Receiver once the AFC has its signal, loaded
    into another: every step after bit-equal to the straight run, the AFC
    and the per-frame tuning continuing exactly."""
    p, iq = eme_port["p"], eme_port["iq"]
    at = eme_port["status"].index(2)
    rx = Receiver(p, device="cpu", graphed=True)
    rx.tune(EME_TUNE_HZ)
    s = rx.geo.samples_per_step
    for i in range(at + 1):
        rx.process_block(iq[i * s:(i + 1) * s])
    path = str(tmp_path / "eme.npz")
    save_receiver(path, rx)
    back = load_receiver(path, device="cpu", graphed=True)
    assert back.graphed and set(back.graphs) == {"bin", "coherent"}
    assert back._tune_slope is not None
    for i in range(at + 1, EME_STEPS):
        _equal_outputs(back.process_block(iq[i * s:(i + 1) * s]),
                       eme_port["outs"][i])
        assert back.afc.status == eme_port["status"][i]
    assert back.graphs["coherent"].replays == EME_STEPS - at - 1


def test_outputs_are_the_callers(eme_port):
    """The outputs of step i are copies: neither the graph's outputs nor
    the static state, and the next step leaves them as they were."""
    rx = Receiver(eme_port["p"], device="cpu", graphed=True)
    rx.tune(EME_TUNE_HZ)
    s = rx.geo.samples_per_step
    first = rx.process_block(eme_port["iq"][:s])
    kept = dataclasses.replace(first, **{
        f.name: getattr(first, f.name).clone()
        for f in dataclasses.fields(first)
        if getattr(first, f.name) is not None})
    static = {t.untyped_storage().data_ptr() for g in rx.graphs.values()
              for t in tensor_leaves(g.state)
              + tensor_leaves(g.outputs)}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if v is not None:
            assert v.untyped_storage().data_ptr() not in static, f.name
    rx.process_block(eme_port["iq"][s:2 * s])
    _equal_outputs(first, kept)
    _equal_outputs(first, eme_port["outs"][0])


def test_tables_assigned_after_construction_take_effect():
    """``rx.tables = ...`` copies into the tables the graphs read: a
    calibrated table assigned to a graphed receiver gives what a receiver
    made with it gives."""
    p = convert.params_from_jax(_flagship_params(tiny=True))
    geo = t_derive_geometry(p)
    k = np.fft.fftfreq(geo.fft1_size)
    cal = {"filtercorr": (10 ** (0.2 * k) * np.exp(1j * 3.0 * k)).astype(
        np.complex64)[:, None]}
    iq = _flagship_input(geo, 3)
    ref = Receiver(p, cal, device="cpu", graphed=False)
    rx = Receiver(p, device="cpu", graphed=True)
    plain = Receiver(p, device="cpu", graphed=True)
    tables = rx.tables
    rx.tables = RxTables.create(geo, p, "cpu", cal)
    assert rx.tables is tables          # written into, not rebound
    for r in (ref, rx, plain):
        r.tune(TUNE_HZ)
    for a, b, c in zip(rx.run(iq), ref.run(iq), plain.run(iq)):
        _equal_outputs(a, b)
        assert not torch.equal(a.fft1_power, c.fft1_power)


def test_state_or_tables_of_another_structure_refused():
    p = convert.params_from_jax(_flagship_params(tiny=True))
    geo = t_derive_geometry(p)
    rx = Receiver(p, device="cpu", graphed=True)
    with pytest.raises(ValueError, match="another structure"):
        rx.state = RxState.create(geo, "cpu", spur=True)
    fewer = dataclasses.replace(rx.state, fft1=dataclasses.replace(
        rx.state.fft1, tail=rx.state.fft1.tail[1:]))
    with pytest.raises(ValueError, match="another structure"):
        rx.state = fewer
    other = TRxParams(fft1_n_override=9, target_fft1_frames_per_step=8)
    with pytest.raises(ValueError, match="another structure"):
        rx.tables = RxTables.create(t_derive_geometry(other), other, "cpu")
    # a tuning of a structure that has no graph
    rx._tune_bin = torch.zeros((geo.fftx_frames_per_step,),
                               dtype=torch.int64)
    with pytest.raises(ValueError, match="no graph"):
        rx.process_block(np.zeros((geo.samples_per_step, 1), np.complex64))


def test_structures_and_the_per_frame_afc():
    """The graphs a receiver captures follow the structures its params
    reach; the non-coherent AFC's per-frame bins run their own graph,
    bit-equal to the eager step."""
    n = 4
    flag = convert.params_from_jax(_flagship_params(tiny=True))
    coh = convert.params_from_jax(_eme_params())
    frames = dataclasses.replace(coh, afc_coherent=False)
    for p, want in ((flag, {"bin": ((), (), None)}),
                    (coh, {"bin": ((), (), None),
                           "coherent": ((n,), (n,), (n,))}),
                    (frames, {"bin": ((), (), None),
                              "frames": ((n,), (), None)})):
        assert tuning_structures(p, t_derive_geometry(p)) == want
    assert Receiver(flag, device="cpu").graphed is False
    iq = _eme_input(t_derive_geometry(frames), EME_STEPS)
    runs = {}
    for graphed in (False, True):
        rx = Receiver(frames, device="cpu", graphed=graphed)
        rx.tune(EME_TUNE_HZ)
        runs[graphed] = (rx, list(rx.run(iq)))
    rx = runs[True][0]
    assert rx.graphs["frames"].replays >= 1 and rx._tune_slope is None
    for a, b in zip(runs[True][1], runs[False][1]):
        _equal_outputs(a, b)


def _afc_shard_params() -> TRxParams:
    return TRxParams(afc_enable=True, filter_low_hz=-150.0,
                     filter_high_hz=150.0, shards=2, fft1_n_override=8,
                     target_fft1_frames_per_step=8, fft3_n=6)


def _drifting(geo, steps: int) -> np.ndarray:
    fs = geo.rx_ad_speed
    n = geo.samples_per_step * steps
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)
    return (0.3 * np.exp(2j * np.pi * (10_000.0 * t + t * t))
            + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def test_sharded_graphed_bit_equal():
    """ShardedReceiver over ["cpu"] * 2 through the coherent AFC's lock:
    graphed and eager give the same bits and the same AFC trajectory, and
    both structures' graphs ran; so do ShardedMultiReceiver and
    ShardedBatchRunner."""
    p = _afc_shard_params()
    geo = t_derive_geometry(p)
    iq = _drifting(geo, 7)
    runs = {}
    for graphed in (False, True):
        rx = ShardedReceiver(p, ["cpu"] * 2, graphed=graphed)
        rx.tune(10_000.0)
        outs, track = [], []
        for out in rx.run(iq):
            outs.append(out)
            track.append((rx.control.afc.status, rx._tune_bin.tolist()))
        runs[graphed] = (rx, outs, track)
    rx = runs[True][0]
    assert rx.graphed and not runs[False][0].graphed
    assert runs[True][2] == runs[False][2]
    assert 3 in [t[0] for t in runs[True][2]]
    assert min(g.replays for g in rx.graphs.values()) >= 1
    for a, b in zip(runs[True][1], runs[False][1]):
        _equal_outputs(a, b)

    q = dataclasses.replace(_afc_shard_params(), afc_enable=False)
    multi = {}
    batch = {}
    for graphed in (False, True):
        mx = ShardedMultiReceiver(q, 3, ["cpu"] * 2, graphed=graphed)
        for k, f in enumerate(MULTI_DIALS):
            mx.tune_subch(k, f)
        multi[graphed] = list(mx.run(iq[:4 * geo.samples_per_step]))
        br = ShardedBatchRunner(q, k_steps=2, devices=["cpu"] * 2,
                                graphed=graphed)
        br.tune(10_000.0)
        batch[graphed] = br.process(iq[:4 * geo.samples_per_step])
        assert (br.graphed is not None) == graphed
    for a, b in zip(multi[True], multi[False]):
        _equal_outputs(a, b)
    for f in ("audio", "baseb"):
        np.testing.assert_array_equal(batch[True][f], batch[False][f])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("cls", [ShardedReceiver, ShardedMultiReceiver,
                                 ShardedBatchRunner])
def test_graphed_refused_without_one_device(cls):
    """A CUDA graph belongs to one device: graphed=True over several
    devices, or over a DistGroup, raises; graphed=None runs eagerly
    there."""
    p = _afc_shard_params()
    args = (3,) if cls is ShardedMultiReceiver else ()
    two_cards = LocalGroup([torch.device("cuda", 0),
                            torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cls(p, *args, devices=two_cards, graphed=True)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        group = DistGroup(["cpu", "cpu"])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls(p, *args, devices=group, graphed=True)
        eager = cls(p, *args, devices=group)
        assert not eager.graphed
    finally:
        dist.destroy_process_group()
