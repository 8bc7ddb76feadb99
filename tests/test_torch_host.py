"""The port's host layer against the JAX package, on device="cpu":
BatchRunner (K steps per call), checkpoint and resume, the latency
budget, WAV replay through the file prefetcher, the watchdog hooks of
Receiver.run and the step timers.

A CUDA graph cannot be made here: on the CPU GraphedStep runs the same
step body eagerly, its write-back of the state over fixed buffers
included, and that path is what these tests hold.  Bars as
tests/test_torch_chain.py: audio <= 2.3e-4 and baseb <= 1e-4 of the
stream's maximum against the JAX package; the port against its own eager
step, a resumed port Receiver against an uninterrupted one and run_file
against run are equal bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import linrad_tpu as jpkg
from linrad_tpu.pipeline import latency as jlat
from linrad_tpu.pipeline.batch import BatchRunner as JaxBatchRunner
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu_torch import RxParams, convert, derive_geometry, runtime
from linrad_tpu_torch.io.siggen import Tone, tones_iq
from linrad_tpu_torch.io.wav import AuxiChunk, RcvrChunk, write_wav
from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
from linrad_tpu_torch.pipeline import latency as tlat
from linrad_tpu_torch.pipeline.batch import (BatchRunner, GraphedStep,
                                             tensor_leaves)
from linrad_tpu_torch.pipeline.chain import (RxState, RxTables,
                                             make_rx_step)
from linrad_tpu_torch.pipeline.checkpoint import (META, load_receiver,
                                                  save_receiver)
from linrad_tpu_torch.pipeline.receiver import Receiver, _pulsewidth
from linrad_tpu_torch.runtime.watchdog import RealTimeMonitor, Watchdog
from linrad_tpu_torch.utils.timing import StepTimer, profile_stages

AUDIO_BAR = 2.3e-4
BASEB_BAR = 1e-4

# the configurations of the JAX package's batch and checkpoint tests
WIDE = dict(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
            second_fft_enable=True, blanker_enable=True,
            clever_bln_limit=6.0, agc_enable=True,
            target_fft1_frames_per_step=16)
NARROW = dict(fft1_n_override=9, agc_enable=False,
              target_fft1_frames_per_step=8)
BATCH = {"wideband": (WIDE, 4, 12_000.0), "narrowband": (NARROW, 3, 10_000.0),
         "wideband-kernel": (dict(WIDE, fft1_variant="pallas"), 4, 12_000.0)}


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _batch_input(geo, n: int, tune_hz: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    iq = (tones_iq(geo.rx_ad_speed, n, [Tone(tune_hz + 400.0)])
          + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n)
                    ).astype(np.complex64))
    iq[::5001] += 40.0
    return iq


def _eager_loop(p: RxParams, tune_bin: torch.Tensor, iq: np.ndarray,
                n_steps: int):
    """The bare make_rx_step loop with the runner's arguments."""
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p, "cpu")
    fir = tables.mix2.fir
    state = RxState.create(geo, "cpu", spur=p.spur_enable,
                           pol=p.pol_adapt_enable,
                           fir_len=int(fir.shape[0]) if fir is not None
                           else 0)
    step = make_rx_step(geo, p, blanker_pulsewidth=_pulsewidth(geo))
    s = geo.samples_per_step
    outs = []
    for i in range(n_steps):
        blk = torch.from_numpy(iq[i * s:(i + 1) * s].reshape(s, -1))
        state, out = step(tables, state, blk, tune_bin)
        outs.append(out)
    return state, outs


# ---- BatchRunner ------------------------------------------------------

@pytest.fixture(scope="module", params=list(BATCH))
def batch(request):
    kw, k, tune_hz = BATCH[request.param]
    jp = jpkg.RxParams(**kw)
    tp = convert.params_from_jax(jp)
    jbr = JaxBatchRunner(jp, k_steps=k)
    tbr = BatchRunner(tp, k_steps=k, device="cpu")
    jbr.tune(tune_hz)
    tbr.tune(tune_hz)
    iq = _batch_input(tbr.geo, 2 * tbr.samples_per_call + 100, tune_hz)
    before = fused_fft1.launches
    got = tbr.process(iq)
    return dict(name=request.param, tp=tp, k=k, tune_hz=tune_hz, iq=iq,
                tbr=tbr, got=got, ref=jbr.process(iq),
                launches=fused_fft1.launches - before)


def test_batch_against_jax(batch):
    got, ref, tbr = batch["got"], batch["ref"], batch["tbr"]
    n = 2 * batch["k"] * tbr.geo.baseband_samples_per_step
    assert set(got) == {"audio", "baseb"}
    assert got["audio"].shape == ref["audio"].shape == (n, 1)
    assert got["baseb"].dtype == np.complex64
    assert _max_rel(got["audio"], ref["audio"]) <= AUDIO_BAR
    assert _max_rel(got["baseb"], ref["baseb"]) <= BASEB_BAR
    assert np.abs(got["audio"]).max() > 0
    # on the CPU the kernel's plain version runs: no launch is counted
    assert batch["launches"] == 0 and tbr.kernel_launches == 0
    assert tbr.kernels_per_replay == 0 and fused_fft1.captured == 0


def test_batch_equals_eager_loop(batch):
    """K steps per call over fixed state buffers give what the functional
    step gives in a loop, bit for bit, the final state included."""
    tp, k = batch["tp"], batch["k"]
    tbr = BatchRunner(tp, k_steps=k, device="cpu")
    tbr.tune(batch["tune_hz"])
    got = tbr.process(batch["iq"])
    state, outs = _eager_loop(tp, tbr._tune_bin.clone(), batch["iq"], 2 * k)
    for f in ("audio", "baseb"):
        want = np.concatenate([getattr(o, f).numpy() for o in outs])
        np.testing.assert_array_equal(got[f], want)
        np.testing.assert_array_equal(got[f], batch["got"][f])
    final = convert.state_to_numpy(tbr.state)
    want = convert.state_to_numpy(state)
    assert set(final) == set(want)
    for key, v in final.items():
        np.testing.assert_array_equal(v, want[key], err_msg=key)
    assert tbr.graphed.replays == 2 * k


def test_batch_against_receiver_at_a_bin_centre(batch):
    """Tuned to a bin centre the Receiver's fractional ramp is zero, so
    its stream is the runner's, to the chain's bars."""
    tp, k, tbr = batch["tp"], batch["k"], batch["tbr"]
    geo = tbr.geo
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    centre = round(batch["tune_hz"] / bin_hz) * bin_hz
    br = BatchRunner(tp, k_steps=k, device="cpu")
    rx = Receiver(tp, device="cpu")
    br.tune(centre)
    rx.tune(centre)
    assert float(rx._tune_frac) == 0.0
    assert int(rx._tune_bin) == int(br._tune_bin)
    iq = batch["iq"][:br.samples_per_call]
    got = br.process(iq)
    outs = list(rx.run(iq))
    audio = np.concatenate([o.audio.numpy() for o in outs])
    baseb = np.concatenate([o.baseb.numpy() for o in outs])
    assert _max_rel(got["audio"], audio) <= AUDIO_BAR
    assert _max_rel(got["baseb"], baseb) <= BASEB_BAR


def test_batch_narrowband_tone_amplitude():
    """tests/test_batch.py::test_batch_narrowband on the port."""
    br = BatchRunner(RxParams(**NARROW), k_steps=3, outputs=("baseb",),
                     device="cpu")
    g = br.geo
    br.tune(10_000.0)
    iq = tones_iq(g.rx_ad_speed, br.samples_per_call * 2, [Tone(10_200.0)])
    got = br.process(iq)
    assert set(got) == {"baseb"}
    z = got["baseb"][:, 0]
    zz = z[len(z) // 2:]
    # true baseband offset accounts for the tune-bin quantisation
    tuned = int(br._tune_bin) * g.timf1_sampling_speed / g.fftx_size
    f_bb = 10_200.0 - tuned
    t = np.arange(len(zz)) / g.baseband_sampling_speed
    amp = abs(np.vdot(np.exp(2j * np.pi * f_bb * t), zz) / len(zz))
    assert abs(amp - 1.0) < 0.01


def test_batch_interface():
    """Trailing samples short of a call are dropped; an empty recording
    gives empty streams; tune writes into the tensor the step reads; other
    outputs can be collected; the state chains across process calls."""
    p = RxParams(**NARROW)
    br = BatchRunner(p, k_steps=3, outputs=("audio", "fft1_power"),
                     device="cpu")
    g = br.geo
    assert br.samples_per_call == 3 * g.samples_per_step
    read_by_step = br._tune_bin
    br.tune(10_000.0)
    assert br._tune_bin is read_by_step and int(br._tune_bin) == round(
        10_000.0 / g.timf1_sampling_speed * g.fftx_size)
    br.tune(-1_000.0)
    assert 0 <= int(br._tune_bin) < g.fftx_size
    br.tune(10_000.0)
    iq = tones_iq(g.rx_ad_speed, 2 * br.samples_per_call, [Tone(10_200.0)])
    short = br.process(iq[:br.samples_per_call - 1])
    assert short["audio"].shape == (0, 1)
    assert br.graphed.replays == 0
    one = br.process(iq[:br.samples_per_call + 5])
    assert one["audio"].shape == (3 * g.baseband_samples_per_step, 1)
    assert one["fft1_power"].shape == (3 * g.fft1_size, 1)
    two = br.process(iq[br.samples_per_call:])
    whole = BatchRunner(p, k_steps=3, outputs=("audio",), device="cpu")
    whole.tune(10_000.0)
    np.testing.assert_array_equal(
        np.concatenate([one["audio"], two["audio"]]),
        whole.process(iq)["audio"])
    # 1-D and (n, 1) recordings are the same recording
    again = BatchRunner(p, k_steps=3, outputs=("audio",), device="cpu")
    again.tune(10_000.0)
    np.testing.assert_array_equal(
        again.process(iq[:, None])["audio"],
        np.concatenate([one["audio"], two["audio"]]))


def test_graphed_step_state_buffers_stay_put():
    """The state lives at fixed addresses: every call writes the new state
    over the buffers the step reads, assigning a state copies into them,
    and the caller's initial state is left alone."""
    p = RxParams(**WIDE)
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p, "cpu")
    init = RxState.create(geo, "cpu")
    kept = [t.clone() for t in tensor_leaves(init)]
    step = make_rx_step(geo, p, blanker_pulsewidth=_pulsewidth(geo))
    tune = torch.full((), 256, dtype=torch.int64)
    gs = GraphedStep(step, tables, init, (geo.samples_per_step, 1),
                     torch.complex64, (tune,))
    assert gs.graph is None and gs.device.type == "cpu"
    ptrs = [t.data_ptr() for t in tensor_leaves(gs.state)]
    assert not set(ptrs) & {t.data_ptr() for t in tensor_leaves(init)}
    rng = np.random.default_rng(1)
    blk = torch.from_numpy((rng.normal(size=(geo.samples_per_step, 1))
                            + 0j).astype(np.complex64))
    out1 = gs(blk)
    a1 = out1.audio.clone()
    gs()
    assert [t.data_ptr() for t in tensor_leaves(gs.state)] == ptrs
    for t, k in zip(tensor_leaves(init), kept):
        assert torch.equal(t, k)
    assert gs.replays == 2 and gs.outputs.audio.shape == a1.shape
    # back to the start: the same block gives the same first output
    gs.state = init
    assert [t.data_ptr() for t in tensor_leaves(gs.state)] == ptrs
    assert torch.equal(gs(blk).audio, a1)
    state, out = step(tables, init, blk, tune)
    assert torch.equal(out.audio, a1)
    with pytest.raises(ValueError):
        gs.state = dataclasses.replace(init, sellim=None)


ENTRY_POINTS = {
    "BatchRunner": lambda tmp: BatchRunner(RxParams(**NARROW)),
    "Receiver": lambda tmp: Receiver(RxParams(**NARROW)),
    "load_receiver": lambda tmp: load_receiver(_saved(tmp)),
    "measure_latency": lambda tmp: tlat.measure_latency(
        tlat.latency_params(), steps=1, warmup=1),
}


def _saved(tmp_path) -> str:
    path = str(tmp_path / "saved.npz")
    save_receiver(path, Receiver(RxParams(**NARROW), device="cpu"))
    return path


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_need_a_cuda_device_by_default(entry, tmp_path):
    """Nothing carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry](tmp_path)


# ---- checkpoint and resume --------------------------------------------

def test_resume_is_exact(tmp_path):
    """tests/test_checkpoint.py::test_resume_is_exact on the port, every
    output field, and the resumed run against a JAX Receiver that ran
    straight through."""
    jp = jpkg.RxParams(**WIDE)
    p = convert.params_from_jax(jp)
    jrx = JaxReceiver(jp)
    rx = Receiver(p, device="cpu")
    rx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables), "cpu")
    rx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    g = rx.geo
    s = g.samples_per_step
    jrx.tune(12_034.5)
    rx.tune(12_034.5)
    iq = _batch_input(g, 4 * s, 12_000.0)
    for i in range(2):
        rx.process_block(iq[i * s:(i + 1) * s, None])
    path = str(tmp_path / "ckpt.npz")
    save_receiver(path, rx)
    rx2 = load_receiver(path, device="cpu")
    assert rx2.params == p and rx2._steps_done == 2
    assert torch.equal(rx2._tune_bin, rx._tune_bin)
    assert rx2._tune_bin.dtype == torch.int64
    assert torch.equal(rx2._tune_frac, rx._tune_frac)
    assert rx2._tune_frac.dtype == torch.float32 and rx2._tune_slope is None
    rx2.tables = rx.tables      # the JAX package's tables, as rx runs them
    a1 = [rx.process_block(iq[i * s:(i + 1) * s, None]) for i in (2, 3)]
    a2 = [rx2.process_block(iq[i * s:(i + 1) * s, None]) for i in (2, 3)]
    for o1, o2 in zip(a1, a2):
        for f in dataclasses.fields(o1):
            assert torch.equal(getattr(o1, f.name), getattr(o2, f.name)), \
                f.name
    final, final2 = (convert.state_to_numpy(r.state) for r in (rx, rx2))
    for key, v in final.items():
        np.testing.assert_array_equal(v, final2[key], err_msg=key)
    j_audio = np.concatenate([np.asarray(o.audio) for o in jrx.run(iq)])
    t_audio = np.concatenate([o.audio.numpy() for o in a2])
    assert _max_rel(t_audio, j_audio[len(j_audio) // 2:]) <= AUDIO_BAR


def test_checkpoint_file_layout(tmp_path):
    """State leaves under their field paths, the meta of the JAX
    package's checkpoint, nothing pickled."""
    rx = Receiver(dataclasses.replace(RxParams(**WIDE), spur_enable=True),
                  device="cpu")
    rx.tune(5_000.0)
    path = str(tmp_path / "layout.npz")
    save_receiver(path, rx)
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        meta = json.loads(str(z[META]))
    assert names - {META} == set(convert.flatten(rx.state))
    assert {"fft1.tail", "fft1.sumsq_avg", "spur.bins"} <= names
    assert not any(n.startswith("leaf_") for n in names)
    assert set(meta) == {"params", "tune_bin", "tune_frac", "tune_slope",
                         "steps_done"}
    assert RxParams.from_json(meta["params"]) == rx.params
    # a configuration with fewer optional fields reads the leaves it has
    rx2 = load_receiver(path, device="cpu")
    assert rx2.state.spur is not None and rx2.state.pol is None


def test_afc_state_survives(tmp_path):
    """tests/test_checkpoint.py::test_afc_state_survives on the port:
    saved after the AFC has its signal, the copy continues with the same
    per-frame tuning, and the JAX Receiver's AFC reached the same state
    on this input."""
    kw = dict(first_fft_bandwidth=30.0, mix1_bandwidth_reduction_n=4,
              afc_enable=True, agc_enable=False,
              target_fft1_frames_per_step=16)
    jrx = JaxReceiver(jpkg.RxParams(**kw))
    rx = Receiver(RxParams(**kw), device="cpu")
    g = rx.geo
    jrx.tune(10_000.0)
    rx.tune(10_000.0)
    n = g.samples_per_step * 10
    t = np.arange(n) / g.rx_ad_speed
    iq = (0.3 * np.exp(2j * np.pi * 10_000.0 * t)).astype(np.complex64)
    first, rest = iq[:8 * g.samples_per_step], iq[8 * g.samples_per_step:]
    for _ in rx.run(first):
        pass
    for _ in jrx.run(first):
        pass
    assert rx.afc.status in (2, 3)
    path = str(tmp_path / "afc.npz")
    save_receiver(path, rx)
    rx2 = load_receiver(path, device="cpu")
    assert rx2.afc.status == rx.afc.status == jrx.afc.status
    assert rx2.afc.freq_hz == rx.afc.freq_hz
    assert rx.afc.freq_hz == pytest.approx(jrx.afc.freq_hz, abs=1e-3)
    assert rx2.afc._times == rx.afc._times
    assert rx2.afc._freqs == rx.afc._freqs
    assert rx2.afc._weights == rx.afc._weights
    assert rx2._steps_done == rx._steps_done == 8
    assert rx2._tune_bin.shape == (g.fftx_frames_per_step,)
    assert torch.equal(rx2._tune_bin, rx._tune_bin)
    a1 = [o for o in rx.run(rest)]
    a2 = [o for o in rx2.run(rest)]
    for o1, o2 in zip(a1, a2, strict=True):
        assert torch.equal(o1.audio, o2.audio)
        assert torch.equal(o1.baseb, o2.baseb)
    assert torch.equal(rx2._tune_bin, rx._tune_bin)
    assert rx2.afc.freq_hz == rx.afc.freq_hz


# ---- latency ----------------------------------------------------------

LATENCY_PARAMS = {f"preset-{m.name}": jpkg.preset(m) for m in jpkg.RxMode}
LATENCY_PARAMS.update({
    "latency": jlat.latency_params(),
    "latency-fft2": jlat.latency_params(second_fft=True),
    "latency-48k": jlat.latency_params(48_000, fft3_n=7),
    "wide": jpkg.RxParams(**WIDE),
})


@pytest.mark.parametrize("name", list(LATENCY_PARAMS))
def test_pipeline_delay_samples(name):
    jp = LATENCY_PARAMS[name]
    want = jlat.pipeline_delay_samples(jpkg.derive_geometry(jp))
    got = tlat.pipeline_delay_samples(
        derive_geometry(convert.params_from_jax(jp)))
    assert got == want and got > 0


@pytest.mark.parametrize("kw", [{}, dict(second_fft=True),
                                dict(rx_ad_speed=48_000),
                                dict(second_fft=True, agc_enable=False,
                                     blanker_enable=False)],
                         ids=["default", "fft2", "48k", "overrides"])
def test_latency_params(kw):
    assert tlat.latency_params(**kw) == convert.params_from_jax(
        jlat.latency_params(**kw))
    assert tlat.BUDGET_S == jlat.BUDGET_S


def _impulse_emit_step(params: RxParams, pos: int, tune_bin: int = 64) -> int:
    """Feed an impulse at input position pos of step 0; the index of the
    step whose output holds its baseband peak."""
    geo = derive_geometry(params)
    step = make_rx_step(geo, params)
    tables = RxTables.create(geo, params, "cpu")
    state = RxState.create(geo, "cpu")
    n = geo.samples_per_step
    peaks = []
    for k in range(8):
        blk = torch.zeros((n, 1), dtype=torch.complex64)
        if k == 0:
            blk[pos, 0] = 1000.0
        state, out = step(tables, state, blk, torch.tensor(tune_bin))
        peaks.append(float(out.baseb[:, 0].abs().max()))
    return int(np.argmax(peaks))


@pytest.mark.parametrize("second_fft", [False, True],
                         ids=["narrowband", "wideband"])
def test_availability_bound(second_fft):
    """pipeline_delay_samples is a tight availability bound on the port's
    chain too: the impulse surfaces in the step the analytic delay
    predicts or the one before, never later."""
    kw = dict(blanker_enable=False) if second_fft else {}
    p = tlat.latency_params(second_fft=second_fft, agc_enable=False, **kw)
    geo = derive_geometry(p)
    n = geo.samples_per_step
    d = tlat.pipeline_delay_samples(geo)
    for pos in (n // 2, 100, n - 100):
        k_pred = int((pos + d) // n)
        k_meas = _impulse_emit_step(p, pos)
        assert k_pred - 1 <= k_meas <= k_pred, (pos, d, k_meas, k_pred)


@pytest.mark.parametrize("second_fft", [False, True])
def test_measure_latency_reports(second_fft):
    """The dictionary of the JAX function, the arithmetic parts equal to
    its values (the times are the CPU's and are not compared)."""
    p = tlat.latency_params(second_fft=second_fft)
    rep = tlat.measure_latency(p, steps=5, warmup=1, device="cpu")
    ref = jlat.measure_latency(jlat.latency_params(second_fft=second_fft),
                               steps=2, warmup=1)
    assert list(rep) == list(ref) == [
        "block_ms", "proc_ms_p50", "proc_ms_p95", "pipeline_ms", "total_ms",
        "budget_ms", "within_budget", "sustained"]
    for k in ("block_ms", "pipeline_ms", "budget_ms"):
        assert rep[k] == ref[k], k
    assert 0 < rep["proc_ms_p50"] <= rep["proc_ms_p95"]
    assert rep["total_ms"] == pytest.approx(
        rep["block_ms"] + rep["proc_ms_p95"] + rep["pipeline_ms"], abs=0.02)
    assert isinstance(rep["within_budget"], bool)
    assert isinstance(rep["sustained"], bool)
    geo = derive_geometry(p)
    fs = geo.timf1_sampling_speed
    assert (geo.samples_per_step + tlat.pipeline_delay_samples(geo)) / fs \
        < tlat.BUDGET_S - 0.040


# ---- run_file ---------------------------------------------------------

def _file_params(**kw) -> RxParams:
    kw.setdefault("fft1_n_override", 9)
    kw.setdefault("agc_enable", False)
    kw.setdefault("target_fft1_frames_per_step", 8)
    kw.setdefault("mix1_bandwidth_reduction_n", 4)
    return RxParams(**kw)


@pytest.fixture(params=["native", "python-thread"])
def prefetcher(request, monkeypatch):
    if request.param == "python-thread":
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
    else:
        assert runtime.get_lib() is not None
    return request.param


@pytest.mark.parametrize("channels", [1, 2])
def test_run_file_matches_inmemory(channels, tmp_path, prefetcher):
    """16-bit IQ through the prefetcher: the audio of run() on the same
    rounded samples bit for bit, the partial last block dropped."""
    p = _file_params(rx_rf_channels=channels)
    rx_mem = Receiver(p, device="cpu")
    rx_file = Receiver(p, device="cpu")
    g = rx_mem.geo
    n = g.samples_per_step * 3 + 77
    iq = np.stack([tones_iq(g.rx_ad_speed, n,
                            [Tone(10_200.0, amplitude=1000.0 / (c + 1))])
                   for c in range(channels)], axis=1)
    iq = (np.round(iq.real) + 1j * np.round(iq.imag)).astype(np.complex64)
    path = str(tmp_path / "rec.wav")
    write_wav(path, iq, g.rx_ad_speed, bits=16)
    rx_mem.tune(10_000.0)
    rx_file.tune(10_000.0)
    a_mem = [o.audio.numpy() for o in rx_mem.run(iq)]
    a_file = [o.audio.numpy() for o in rx_file.run_file(path)]
    assert len(a_file) == len(a_mem) == 3
    np.testing.assert_array_equal(np.concatenate(a_file),
                                  np.concatenate(a_mem))
    assert np.abs(a_file[-1]).max() > 0
    assert rx_file.center_frequency_hz == 0.0


@pytest.mark.parametrize("chunk", ["rcvr", "auxi"])
@pytest.mark.parametrize("bits", [16, 24])
def test_center_frequency_from_chunk(chunk, bits, tmp_path):
    """The RF centre of the capture's metadata chunk, through the
    prefetcher (16 bit) and through read_wav (other layouts), then dial
    tuning by it."""
    rx = Receiver(_file_params(), device="cpu")
    g = rx.geo
    iq = tones_iq(g.rx_ad_speed, 2 * g.samples_per_step,
                  [Tone(1_000.0, amplitude=1000.0)])
    tag = {"rcvr": dict(rcvr=RcvrChunk(center_frequency_hz=14_100_000)),
           "auxi": dict(auxi=AuxiChunk(center_freq=14_100_000))}[chunk]
    path = str(tmp_path / "tagged.wav")
    write_wav(path, iq.astype(np.complex64)[:, None], g.rx_ad_speed,
              bits=bits, **tag)
    outs = list(rx.run_file(path))
    assert len(outs) == 2
    assert rx.center_frequency_hz == 14_100_000.0
    rx.tune_rf(14_101_000.0)
    assert rx.tuned_hz == pytest.approx(1_000.0, abs=1e-3)
    assert rx.tuned_rf_hz == pytest.approx(14_101_000.0, abs=1e-3)


def test_run_file_other_layout_matches_run(tmp_path):
    """A float32 recording goes through read_wav and run()."""
    p = _file_params()
    rx_mem = Receiver(p, device="cpu")
    rx_file = Receiver(p, device="cpu")
    g = rx_mem.geo
    iq = tones_iq(g.rx_ad_speed, 2 * g.samples_per_step, [Tone(10_200.0)])
    path = str(tmp_path / "float.wav")
    write_wav(path, iq[:, None], g.rx_ad_speed, bits=32)
    a_mem = np.concatenate([o.audio.numpy() for o in rx_mem.run(iq)])
    a_file = np.concatenate([o.audio.numpy()
                             for o in rx_file.run_file(path)])
    np.testing.assert_array_equal(a_file, a_mem)


@pytest.mark.parametrize("body,match", [(b"JUNKJUNKJUNKJUNK", "not a WAV"),
                                        (b"RIFF\x04\x00\x00\x00WAVE",
                                         "missing data chunk")])
def test_run_file_refuses_bad_files(body, match, tmp_path):
    path = tmp_path / "bad.wav"
    path.write_bytes(body)
    rx = Receiver(_file_params(), device="cpu")
    with pytest.raises(ValueError, match=match):
        list(rx.run_file(str(path)))


# ---- watchdog hooks and timers ----------------------------------------

def test_run_beats_watchdog_and_monitor():
    """tests/test_watchdog.py::test_receiver_integration on the port."""
    p = RxParams(fft1_n_override=9, agc_enable=False)
    geo = derive_geometry(p)
    rx = Receiver(p, device="cpu")
    wd = Watchdog(timeout_s=30.0)
    mon = RealTimeMonitor(rate_hz=geo.rx_ad_speed, headroom_s=10.0)
    iq = np.zeros(2 * geo.samples_per_step, np.complex64)
    outs = list(rx.run(iq, watchdog=wd, monitor=mon))
    assert len(outs) == 2
    assert wd.stalled() == []
    assert mon.samples == 2 * geo.samples_per_step
    mon.check()


def test_step_timer_and_profile_stages():
    timer = StepTimer(sample_rate=96_000.0, samples_per_step=1024)
    x = torch.ones(64)
    for _ in range(3):
        timer.start()
        y = x * 2
        assert timer.stop(y) > 0
    rep = timer.report()
    assert list(rep) == ["steps", "mean_step_ms", "msamples_per_s",
                         "realtime_factor"]
    assert rep["steps"] == 3
    assert rep["mean_step_ms"] == pytest.approx(
        1e3 * sum(timer._times[1:]) / 2)
    assert timer.realtime_factor == pytest.approx(
        timer.samples_per_second / 96_000.0)
    stages = profile_stages({"mul": lambda: x * 2,
                             "pair": lambda: (x + 1, x - 1)}, repeats=3)
    assert set(stages) == {"mul", "pair"}
    assert all(v > 0 for v in stages.values())
