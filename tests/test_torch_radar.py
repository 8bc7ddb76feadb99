"""The port's weak/radar.py and the WFM stereo decoder against the JAX
package, on device="cpu".

Radar: frame_pulse_stats on the same seeded power spectra (peak bins
exact; S/N and noise floor to 1e-5: the floor is a float32 sum over a
row, taken in another order), the walk ends held to a numpy rendering of
the reference's while-loops, and the whole RadarTracker fed the same
frames as the JAX package's (every host decision exact, the display
matrix to 1e-5).  Then the JAX package's own radar tests on the port
alone, the spectra from the port's fft1_step.  The radar mode's device
path, RadarFront (fft1, the frames' power and frame_pulse_stats as one
step, replayed from a CUDA graph on a card; graphed=True on the CPU runs
the graph's body eagerly), bit-equal to the plain functions and against
the JAX package's jitted functions, and feeding a tracker that locks as
the JAX tracker does on preset(RxMode.RADAR)'s front end.

WFM stereo: wfm_stereo_decode against the JAX function to 1e-4 of the
output's maximum.  The bar is that wide because the sine's float32
argument reaches 3e4 rad at these lengths, where one step of float32 is
2e-3 rad: both packages build the argument in the same order, but their
sine and cosine routines round such arguments differently, and the pilot
phase comes from a sum of 5e4 terms taken in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linrad_tpu import RxMode as JRxMode
from linrad_tpu import preset as j_preset
from linrad_tpu.geometry import derive_geometry as j_derive_geometry
from linrad_tpu.ops import fft1 as jfft1
from linrad_tpu.pipeline.receiver import Receiver as JaxReceiver
from linrad_tpu.ops import demod as jdemod
from linrad_tpu.params import RxParams as JaxRxParams
from linrad_tpu.tx.keying import radar_pulse_train as j_radar_pulse_train
from linrad_tpu.viz import radar_graph_image as j_radar_graph_image
from linrad_tpu.weak import radar as jradar
from linrad_tpu_torch import RxParams, convert, derive_geometry
from linrad_tpu_torch.io.modeinput import radar_iq
from linrad_tpu_torch.ops import demod as tdemod
from linrad_tpu_torch.ops.fft1 import FFT1State, FFT1Tables, fft1_step
from linrad_tpu_torch.tx.keying import radar_pulse_train
from linrad_tpu_torch.viz import radar_graph_image
from linrad_tpu_torch.weak import radar as tradar
from linrad_tpu_torch.pipeline.receiver import Receiver
from linrad_tpu_torch.weak.radar import (RadarFront, RadarParams,
                                         RadarTracker, frame_power,
                                         frame_pulse_stats)

FS = 96_000
PULSE_SEP_FRAMES = 40          # transforms between TX pulses
PULSE_WIDTH_FRAMES = 3
ECHO_DELAY_FRAMES = 8
TX_BIN = 100                   # carrier at bin 100 = 9375 Hz
FP32 = 1e-5
RADAR_KW = dict(first_fft_bandwidth=200.0, target_fft1_frames_per_step=32)


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _radar_iq(geo, n_steps: int, echo_amp: float = 0.05,
              noise: float = 1e-3, seed: int = 7,
              doppler_bins: int = 0) -> np.ndarray:
    """TX leak-through + delayed (and doppler-shifted) echo + receive
    noise, with the RX front end muted during transmit (the radar
    operating condition radar.c:186-193 relies on)."""
    stride = geo.fft1_new_points
    n = n_steps * geo.samples_per_step
    period = PULSE_SEP_FRAMES * stride
    width = PULSE_WIDTH_FRAMES * stride
    delay = ECHO_DELAY_FRAMES * stride
    rng = np.random.default_rng(seed)
    env = radar_pulse_train(FS, FS / period, width / FS, n / FS,
                            rise_s=0.0002)[:n]
    t = np.arange(n)
    tx = env * np.exp(2j * np.pi * TX_BIN / geo.fft1_size * t)
    ec = env * np.exp(2j * np.pi * (TX_BIN + doppler_bins)
                      / geo.fft1_size * t)
    echo = np.zeros(n, np.complex128)
    echo[delay:] = echo_amp * ec[:-delay]
    nz = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    nz *= np.where(env > 0.01, 0.01, 1.0)      # RX muted during TX
    return (tx + echo + nz).astype(np.complex64)


def _port_power_frames(iq: np.ndarray, n_steps: int) -> list[np.ndarray]:
    """Per step (frames, bins, 1) power spectra from the port's fft1."""
    geo = derive_geometry(RxParams(**RADAR_KW))
    tables = FFT1Tables.create(geo, "cpu", edge_taper=False)
    state = FFT1State.create(geo, "cpu")
    out = []
    s = geo.samples_per_step
    for i in range(n_steps):
        blk = torch.from_numpy(iq[i * s:(i + 1) * s, None])
        state, spec, _ = fft1_step(geo, tables, state, blk, avg1num=64)
        out.append(spec.abs().numpy() ** 2)
    return out


def _tracker(mod=tradar, **kw):
    geo = derive_geometry(RxParams(**RADAR_KW))
    extra = {"device": "cpu"} if mod is tradar else {}
    kw.setdefault("params", mod.RadarParams(time=2.0, lock_after=500))
    return mod.RadarTracker(n_bins=geo.fft1_size,
                            frame_time_s=geo.fft1_new_points / FS,
                            **kw, **extra)


# ---- frame_pulse_stats against JAX and against the reference's loops --

def _walk_ends(row: np.ndarray, k: int) -> tuple[int, int]:
    """The reference's two while-loops (radar.c:206-216), unbounded."""
    n = len(row)
    ia = k
    while ia - 2 >= 0 and row[ia] > row[ia - 1] and row[ia] > row[ia - 2]:
        ia -= 1
    ib = k
    while ib + 2 <= n - 1 and row[ib] > row[ib + 1] and row[ib] > row[ib + 2]:
        ib += 1
    return ia, ib + 1


def _stats_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    pw = rng.random((16, 256)).astype(np.float32)
    if name == "spike":
        pw[5, 60] = 5000.0
    elif name == "skirts":
        # smooth skirts of different widths, peaks at the edges too
        bins = np.arange(256)
        for f, (c, w) in enumerate([(0, 3.0), (1, 2.0), (255, 4.0),
                                    (254, 1.5), (60, 6.0), (128, 5.0),
                                    (200, 0.7), (30, 4.5)]):
            pw[f] += 1e4 * np.exp(-0.5 * ((bins - c) / w) ** 2
                                  ).astype(np.float32)
    elif name == "long_skirt":
        # a skirt longer than walk_steps: the bounded walk stops short
        pw[:] = 0.001 * pw
        pw += (1000.0 - 5.0 * np.abs(np.arange(256) - 128)
               ).astype(np.float32)[None, :]
    return pw


@pytest.mark.parametrize("case", ["noise", "spike", "skirts", "long_skirt"])
def test_frame_pulse_stats_against_jax(case):
    pw = _stats_case(case)
    tk, tston, tfloor = frame_pulse_stats(torch.from_numpy(pw))
    jk, jston, jfloor = jradar.frame_pulse_stats(jnp.asarray(pw))
    assert tk.dtype == torch.int64 and tston.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert _max_rel(tston.numpy(), jston) <= FP32
    assert _max_rel(tfloor.numpy(), jfloor) <= FP32


@pytest.mark.parametrize("case", ["noise", "spike", "skirts"])
def test_frame_pulse_stats_walk_ends_exact(case):
    """The floor is the mean outside [ia, ib): recomputed in float64 from
    the reference's unbounded walks it must match, which pins both walk
    ends (a walk one bin off moves the floor by far more than 1e-5 on
    these inputs)."""
    pw = _stats_case(case)
    k, ston, floor = (a.numpy() for a in
                      frame_pulse_stats(torch.from_numpy(pw)))
    for f in range(pw.shape[0]):
        row = pw[f].astype(np.float64)
        assert k[f] == int(np.argmax(row))
        ia, ib = _walk_ends(row, int(k[f]))
        assert ib - ia <= 65
        want = (row[:ia].sum() + row[ib:].sum()) / max(256 - (ib - ia), 1)
        assert abs(floor[f] - want) <= FP32 * want, (f, ia, ib)
        assert abs(ston[f] - row[k[f]] / want) <= FP32 * ston[f]


def test_frame_pulse_stats_walk_is_bounded():
    """walk_steps bounds each walk exactly as the JAX fori_loop does."""
    pw = _stats_case("long_skirt")
    for steps in (4, 32):
        _, _, tfloor = frame_pulse_stats(torch.from_numpy(pw), steps)
        _, _, jfloor = jradar.frame_pulse_stats(jnp.asarray(pw), steps)
        assert _max_rel(tfloor.numpy(), jfloor) <= FP32
        row = pw[0].astype(np.float64)
        want = (row[:128 - steps].sum() + row[129 + steps:].sum()) \
            / (256 - 2 * steps - 1)
        assert abs(float(tfloor[0]) - want) <= FP32 * want


def test_accumulate_against_jax():
    rng = np.random.default_rng(4)
    avg = rng.random((60, 64)).astype(np.float32)
    frames = rng.random((512, 256)).astype(np.float32)
    for start in (0, 17, 452):
        t = tradar._accumulate(torch.from_numpy(avg),
                               torch.from_numpy(frames), start, 0.9, 60,
                               68, 132)
        j = jradar._accumulate(jnp.asarray(avg), jnp.asarray(frames), start,
                               0.9, 60, 68, 132)
        assert t.shape == (60, 64)
        assert _max_rel(t.numpy(), j) <= FP32


# ---- the tracker against the JAX package's, same frames ---------------

@pytest.fixture(scope="module", params=["echo", "doppler"])
def trackers(request):
    doppler = 5 if request.param == "doppler" else 0
    n_steps = 26
    geo = derive_geometry(RxParams(**RADAR_KW))
    jgeo = j_derive_geometry(JaxRxParams(**RADAR_KW))
    assert geo.fft1_size == jgeo.fft1_size
    iq = _radar_iq(geo, n_steps, doppler_bins=doppler,
                   seed=9 if doppler else 7)
    frames = _port_power_frames(iq, n_steps)
    bin_hz = FS / geo.fft1_size
    tt = _tracker(tradar, bin_hz=bin_hz)
    jt = _tracker(jradar, bin_hz=bin_hz)
    history = []
    for pw in frames:
        tt.feed(pw)
        jt.feed(pw)
        history.append(((tt.locked, tt.update_cnt, tt._consumed,
                         tt._next_scan, len(tt._ston)),
                        (jt.locked, jt.update_cnt, jt._consumed,
                         jt._next_scan, len(jt._ston))))
    return dict(tt=tt, jt=jt, history=history, doppler=doppler,
                bin_hz=bin_hz)


def test_tracker_decisions_equal_jax(trackers):
    tt, jt = trackers["tt"], trackers["jt"]
    for i, (t, j) in enumerate(trackers["history"]):
        assert t == j, f"step {i}"
    assert tt.locked and jt.locked
    for name in ("pulse_sep", "pulse_bin", "lines", "first_bin", "last_bin",
                 "decayfac", "update_cnt"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt._bins == jt._bins
    assert _max_rel(tt._ston, jt._ston) <= FP32
    assert _max_rel(tt._floor, jt._floor) <= FP32


def test_radar_pulse_train_equal_jax():
    """The port's tx.keying.radar_pulse_train, which builds this file's
    radar input, is the JAX package's bit for bit."""
    for kw in (dict(prf_hz=100.0, pulse_s=0.001, duration_s=1.0),
               dict(prf_hz=FS / 1280, pulse_s=96 / FS, duration_s=0.5,
                    rise_s=0.0002)):
        got = radar_pulse_train(FS, **kw)
        ref = j_radar_pulse_train(FS, **kw)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_radar_graph_image_against_jax(trackers):
    """viz.radar_graph_image (make_radar_graph radar.c:422-520) of the
    port's tracker against the JAX package's of its tracker fed the same
    frames (the averages agree to 1e-5, so the images do); the JAX
    function on the port's tracker gives the port's image bit for bit;
    before lock the image is empty in both."""
    tt, jt = trackers["tt"], trackers["jt"]
    img = radar_graph_image(tt)
    assert img.dtype == np.float32 and img.shape == tt.average.shape
    assert np.all((img >= 0) & (img <= 1)) and img.max() == 1.0
    assert _max_rel(img, j_radar_graph_image(jt)) <= FP32
    np.testing.assert_array_equal(j_radar_graph_image(tt), img)
    np.testing.assert_array_equal(radar_graph_image(tt, -30.0),
                                  j_radar_graph_image(tt, -30.0))
    assert radar_graph_image(_tracker()).shape == (0, 0)


def test_tracker_display_equal_jax(trackers):
    tt, jt = trackers["tt"], trackers["jt"]
    assert tt.average.shape == jt.average.shape == (tt.lines,
                                                    tt.last_bin - tt.first_bin)
    assert tt.average.dtype == np.float32
    assert _max_rel(tt.average, jt.average) <= FP32
    assert _max_rel(tt.range_profile(), jt.range_profile()) <= FP32
    assert _max_rel(tt.display_image(), jt.display_image()) <= FP32
    assert tt.echo_peak() == jt.echo_peak()
    line, off, dopp = tt.echo_peak()
    assert abs(line - ECHO_DELAY_FRAMES) <= 1
    assert off == trackers["doppler"]
    assert dopp == pytest.approx(off * trackers["bin_hz"])


# ---- the JAX package's radar tests, on the port alone -----------------

def test_frame_pulse_stats_flags_pulse_frames():
    pw = _stats_case("spike")
    k, ston, floor = (a.numpy() for a in
                      frame_pulse_stats(torch.from_numpy(pw)))
    assert k[5] == 60
    assert ston[5] > 100 * np.median(ston)
    assert abs(floor[5] - 0.5) < 0.1


def test_radar_round_trip_lock_and_range():
    geo = derive_geometry(RxParams(**RADAR_KW))
    n_steps = 26                        # 832 frames, about 20 pulses
    tracker = _tracker()
    for pw in _port_power_frames(_radar_iq(geo, n_steps), n_steps):
        tracker.feed(pw)
    # pulse-train identification (run_radar radar.c:227-345)
    assert tracker.locked
    assert tracker.pulse_sep == PULSE_SEP_FRAMES
    assert tracker.pulse_bin == TX_BIN
    assert tracker.lines == PULSE_SEP_FRAMES + 20
    assert tracker.update_cnt >= 8
    # range display: TX pulse then echo ECHO_DELAY_FRAMES lines later
    prof = tracker.range_profile()
    assert len(prof) == tracker.lines
    tx_line = int(np.argmax(prof > 0.5 * prof.max()))
    assert tx_line < 14                 # 10-transform backup + smear
    masked = prof.copy()
    for p0 in (tx_line, tx_line + PULSE_SEP_FRAMES):
        lo = max(p0 - PULSE_WIDTH_FRAMES - 2, 0)
        masked[lo: p0 + PULSE_WIDTH_FRAMES + 3] = 0.0
    echo_line = int(np.argmax(masked))
    assert abs((echo_line - tx_line) - ECHO_DELAY_FRAMES) <= 1
    floor = np.median(masked[masked > 0]) if np.any(masked > 0) else 0.0
    assert masked[echo_line] > 10 * floor
    # range conversion: line offset -> metres (c * t / 2)
    rng_m = tracker.line_to_range_m(echo_line - tx_line)
    expect = 299_792_458.0 * ECHO_DELAY_FRAMES * geo.fft1_new_points \
        / FS / 2.0
    assert abs(rng_m - expect) / expect < 0.2
    img = tracker.display_image()
    assert img.shape == tracker.average.shape
    assert np.all((img >= 0) & (img <= 1))


def test_radar_no_lock_without_pulses():
    rng = np.random.default_rng(3)
    tracker = _tracker(params=RadarParams(lock_after=100))
    for _ in range(6):
        tracker.feed(rng.random((32, tracker.n_bins)).astype(np.float32))
    assert not tracker.locked
    assert tracker.average.shape == (0, 0)
    assert tracker.range_profile().shape == (0,)
    assert tracker.echo_peak() == (0, 0, None)


def test_radar_display_image_mapping():
    """The intensity mapping of make_radar_cfac, the tracker's own
    display_image (viz.radar_graph_image, the radar graph, is held to the
    JAX package's in test_radar_graph_image_against_jax)."""
    tracker = _tracker(params=RadarParams(gain=100.0))
    tracker._avg = torch.tensor([[1.0, 1e30], [0.01, 1e-9]])
    img = tracker.display_image()
    assert img.shape == (2, 2)
    assert img[0, 1] == 1.0 and img[1, 1] == 0.0
    assert np.all((img >= 0) & (img <= 1))
    jt = _tracker(jradar, params=jradar.RadarParams(gain=100.0))
    jt._avg = jnp.asarray(tracker._avg.numpy())
    np.testing.assert_allclose(img, jt.display_image(), rtol=1e-6)


def test_radar_history_stays_bounded():
    """A long run: the host-side frame history must stay
    bounded (the fft1_sumsq ring analog): scanning must advance past
    pulses whose windows left the buffer rather than stall trimming."""
    geo = derive_geometry(RxParams(**RADAR_KW))
    n_steps = 60
    tracker = _tracker()
    for pw in _port_power_frames(_radar_iq(geo, n_steps), n_steps):
        tracker.feed(pw)
    assert tracker.locked
    assert tracker.update_cnt >= 30
    buffered = sum(len(a) for a in tracker._hist_pw)
    keep = max(4 * tracker.pulse_sep + tracker.lines + 64,
               tracker.params.lock_after + 64)
    assert buffered <= keep + 32 * 2   # within one step of the bound


def test_radar_doppler_shifted_echo():
    """EME regime: the echo comes back doppler-shifted; echo_peak reads
    (range line, frequency offset, doppler Hz) off the display."""
    geo = derive_geometry(RxParams(**RADAR_KW))
    n_steps, dopp_bins = 26, 5
    bin_hz = FS / geo.fft1_size
    tracker = _tracker(bin_hz=bin_hz)
    iq = _radar_iq(geo, n_steps, seed=9, doppler_bins=dopp_bins)
    for pw in _port_power_frames(iq, n_steps):
        tracker.feed(pw)
    assert tracker.locked and tracker.pulse_bin == TX_BIN
    line, off, dopp = tracker.echo_peak()
    assert abs(line - ECHO_DELAY_FRAMES) <= 1
    assert off == dopp_bins
    assert dopp == pytest.approx(dopp_bins * bin_hz)


def test_radar_tracker_needs_a_cuda_device_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        RadarTracker(n_bins=256, frame_time_s=0.01)


# ---- the radar mode's device path: RadarFront ------------------------

RADAR_STEPS = 20            # 1,280 frames of preset(RADAR): 32 pulses


def _radar_mode_pair(variant=None):
    """The JAX Receiver and the port's (CPU) of preset(RxMode.RADAR), the
    port's tables the JAX one's."""
    jrx = JaxReceiver(j_preset(JRxMode.RADAR, fft1_variant=variant))
    rx = Receiver(convert.params_from_jax(jrx.params), device="cpu")
    rx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables), "cpu")
    return jrx, rx


def _radar_mode_iq(geo, steps, doppler=0):
    return radar_iq(geo, steps, tx_bin=TX_BIN, pulse_sep=PULSE_SEP_FRAMES,
                    pulse_width=PULSE_WIDTH_FRAMES,
                    echo_delay=ECHO_DELAY_FRAMES, doppler_bins=doppler)


def test_radar_iq_is_the_tests_input():
    """io.modeinput.radar_iq, which chip_smoke.py's radar phase feeds, is
    this file's _radar_iq."""
    geo = derive_geometry(RxParams(**RADAR_KW))
    for dop, seed in ((0, 7), (5, 9)):
        np.testing.assert_array_equal(
            radar_iq(geo, 3, tx_bin=TX_BIN, pulse_sep=PULSE_SEP_FRAMES,
                     pulse_width=PULSE_WIDTH_FRAMES,
                     echo_delay=ECHO_DELAY_FRAMES, doppler_bins=dop,
                     seed=seed),
            _radar_iq(geo, 3, doppler_bins=dop, seed=seed))


@pytest.mark.parametrize("variant", ["pallas", None])
def test_radar_front_equals_plain_and_jax(variant):
    """RadarFront graphed (the body eagerly), RadarFront eager and the
    plain functions give the same bits over 3 steps.  Against the JAX
    package (its Pallas kernel in interpret mode for "pallas"): the
    frames' power against its fft1_step's |spec|^2 within 1e-5, the peak
    bins exact, and S/N and floor against its jitted frame_pulse_stats of
    the same power within 1e-5.  (Of JAX's own power the transmit frames'
    S/N differs by 1e-3: the receiver is muted then, and the floor beside
    the pulse is the float32 transforms' roundoff.)"""
    jrx, rx = _radar_mode_pair(variant)
    geo, jgeo = rx.geo, jrx.geo
    assert (geo.fft1_size, geo.fft1_frames_per_step) == (2048, 64)
    graphed = RadarFront.of_receiver(rx, graphed=True)
    eager = RadarFront.of_receiver(rx)
    assert graphed.graphed and not eager.graphed
    iq = _radar_mode_iq(geo, 3)
    s = geo.samples_per_step
    tstate = FFT1State.create(geo, "cpu")
    jstate = jfft1.FFT1State.create(jgeo)
    for i in range(3):
        blk = iq[i * s:(i + 1) * s, None]
        g = graphed(blk)
        e = eager(torch.from_numpy(blk))
        tstate, spec, _ = fft1_step(geo, rx.tables.fft1, tstate,
                                    torch.from_numpy(blk),
                                    rx.params.fft_avg1num, variant=variant)
        power = frame_power(spec)
        plain = (power,) + frame_pulse_stats(power)
        for a, b, c in zip(g, e, plain):
            assert torch.equal(a, b) and torch.equal(a, c)
        jstate, jspec, _ = jfft1.fft1_step(
            jgeo, jrx.tables.fft1, jstate, jnp.asarray(blk),
            jrx.params.fft_avg1num, variant=variant)
        jpow = jnp.sum(jnp.abs(jspec) ** 2, axis=-1)
        assert _max_rel(g[0].numpy(), jpow) <= FP32
        np.testing.assert_array_equal(
            g[1].numpy(), np.asarray(jradar.frame_pulse_stats(jpow)[0]))
        jk, jston, jfloor = jradar.frame_pulse_stats(jnp.asarray(g[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(jk))
        assert _max_rel(g[2].numpy(), jston) <= FP32
        assert _max_rel(g[3].numpy(), jfloor) <= FP32
    assert graphed.graph.replays == 3
    np.testing.assert_array_equal(graphed.state.tail.numpy(),
                                  eager.state.tail.numpy())


def test_feed_takes_a_tensor():
    """feed takes the device's power as a tensor, (frames, bins) or
    (frames, bins, channels): the same decisions, history and display as
    the numpy frames; the history is the tracker's own copy."""
    geo = derive_geometry(RxParams(**RADAR_KW))
    frames = _port_power_frames(_radar_iq(geo, 26), 26)
    a, b, c = _tracker(), _tracker(), _tracker()
    for pw in frames:
        t = torch.from_numpy(pw.copy())
        a.feed(pw)
        b.feed(t)
        c.feed(t[..., 0])
        t.fill_(-1.0)
    for t in (b, c):
        for name in ("locked", "pulse_sep", "pulse_bin", "lines",
                     "update_cnt", "_bins", "_ston", "_floor"):
            assert getattr(t, name) == getattr(a, name), name
        np.testing.assert_array_equal(np.concatenate(t._hist_pw),
                                      np.concatenate(a._hist_pw))
        np.testing.assert_array_equal(t.average, a.average)
    assert a.locked and a.update_cnt >= 8


@pytest.fixture(scope="module", params=[0, 5], ids=["echo", "doppler"])
def radar_mode(request):
    """preset(RxMode.RADAR)'s front end over RADAR_STEPS steps of the
    pulse train: the port's graphed RadarFront feeding a port tracker,
    the JAX fft1_step and |spec|^2 feeding a JAX tracker."""
    jrx, rx = _radar_mode_pair()
    geo, jgeo = rx.geo, jrx.geo
    front = RadarFront.of_receiver(rx, graphed=True)
    kw = dict(n_bins=geo.fft1_size,
              frame_time_s=geo.fft1_new_points / geo.timf1_sampling_speed,
              bin_hz=geo.timf1_sampling_speed / geo.fft1_size)
    tt = tradar.RadarTracker(params=RadarParams(time=2.0, lock_after=500),
                             device="cpu", **kw)
    jt = jradar.RadarTracker(
        params=jradar.RadarParams(time=2.0, lock_after=500), **kw)
    iq = _radar_mode_iq(geo, RADAR_STEPS, request.param)
    s = geo.samples_per_step
    jstate = jfft1.FFT1State.create(jgeo)
    history = []
    for i in range(RADAR_STEPS):
        blk = iq[i * s:(i + 1) * s, None]
        front.feed(tt, blk)
        jstate, jspec, _ = jfft1.fft1_step(
            jgeo, jrx.tables.fft1, jstate, jnp.asarray(blk),
            jrx.params.fft_avg1num)
        jt.feed(np.abs(np.asarray(jspec)) ** 2)
        history.append(((tt.locked, tt.update_cnt, tt._consumed),
                        (jt.locked, jt.update_cnt, jt._consumed)))
    return dict(tt=tt, jt=jt, history=history, doppler=request.param,
                front=front)


def test_radar_mode_locks_as_jax(radar_mode):
    tt, jt = radar_mode["tt"], radar_mode["jt"]
    for i, (t, j) in enumerate(radar_mode["history"]):
        assert t == j, f"step {i}"
    assert tt.locked and tt.pulse_sep == PULSE_SEP_FRAMES
    assert tt.pulse_bin == TX_BIN and tt.update_cnt >= 15
    for name in ("pulse_sep", "pulse_bin", "lines", "first_bin", "last_bin",
                 "decayfac", "update_cnt"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt._bins == jt._bins
    # S/N of the frames off the transmit pulse; on it the floor is the
    # float32 transforms' roundoff (test_radar_front_equals_plain_and_jax)
    ston, jston = np.array(tt._ston), np.array(jt._ston)
    quiet = jston < 1e4
    assert quiet.sum() > len(jston) // 2
    assert _max_rel(ston[quiet], jston[quiet]) <= FP32
    assert radar_mode["front"].graph.replays == RADAR_STEPS


def test_radar_mode_echo_range_as_jax(radar_mode):
    tt, jt = radar_mode["tt"], radar_mode["jt"]
    assert _max_rel(tt.average, jt.average) <= FP32
    line, off, dopp = tt.echo_peak()
    assert (line, off, dopp) == jt.echo_peak()
    assert abs(line - ECHO_DELAY_FRAMES) <= 1
    assert off == radar_mode["doppler"]
    assert tt.line_to_range_m(line) == jt.line_to_range_m(line)


# ---- WFM stereo -------------------------------------------------------

WFM_BAR = 1e-4
WFM_FS = 192_000.0


def _stereo_composite(seconds: float):
    t = np.arange(int(seconds * WFM_FS)) / WFM_FS
    left = np.sin(2 * np.pi * 700.0 * t)
    right = np.sin(2 * np.pi * 2500.0 * t)
    return t, left, right


def test_wfm_stereo_encode_equal():
    _t, left, right = _stereo_composite(0.05)
    a = tdemod.wfm_stereo_encode(left, right, WFM_FS, 0.08, 19_000.0)
    b = jdemod.wfm_stereo_encode(left, right, WFM_FS, 0.08, 19_000.0)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["stereo", "mono", "noise", "cut8k"])
def test_wfm_stereo_decode_against_jax(case):
    t, left, right = _stereo_composite(0.25)
    kw = {}
    if case == "mono":
        comp = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    else:
        comp = tdemod.wfm_stereo_encode(left, right, WFM_FS)
    if case == "noise":
        comp = comp + np.random.default_rng(8).normal(
            size=len(t)).astype(np.float32) * 0.05
    if case == "cut8k":
        kw = dict(audio_cut_hz=8_000.0)
    tl, tr, tp = tdemod.wfm_stereo_decode(torch.from_numpy(comp), WFM_FS,
                                          **kw)
    jl, jr, jp = jdemod.wfm_stereo_decode(jnp.asarray(comp), WFM_FS, **kw)
    assert tl.dtype == torch.float32 and tl.shape == (len(t),)
    assert tp.shape == ()
    scale = max(float(np.max(np.abs(jl))), float(np.max(np.abs(jr))))
    if case == "mono":
        # no pilot: its phase is the angle of a sum that is zero up to
        # roundoff, so the L-R branch is arbitrary (and tiny) on both
        # sides; the sum L+R does not pass through it
        assert float(tp) < 1e-6 and float(jp) < 1e-6
        assert np.max(np.abs((tl + tr).numpy() - np.asarray(jl + jr))) \
            <= WFM_BAR * scale
        assert float((tl - tr).abs().max()) < 5e-3
    else:
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= WFM_BAR * scale
        assert np.max(np.abs(tr.numpy() - np.asarray(jr))) <= WFM_BAR * scale
        assert abs(float(tp) - float(jp)) <= WFM_BAR * float(jp)


def test_wfm_pilot_locked_channel_separation():
    """WFM stereo decode (the fm.c wideband-stereo pilot path): distinct
    L/R tones come out on their own channels with >25 dB separation, and
    the pilot is detected."""
    t, left, right = _stereo_composite(0.25)
    comp = tdemod.wfm_stereo_encode(left, right, WFM_FS)
    l, r, pil = tdemod.wfm_stereo_decode(torch.from_numpy(comp), WFM_FS)
    l, r = l.numpy(), r.numpy()

    def tone_pwr(x, f):
        ref = np.exp(2j * np.pi * f * t)
        return abs(np.vdot(ref, x) / len(x)) ** 2

    sep_l = 10 * np.log10(tone_pwr(l, 700.0) / tone_pwr(l, 2500.0))
    sep_r = 10 * np.log10(tone_pwr(r, 2500.0) / tone_pwr(r, 700.0))
    assert sep_l > 25.0, sep_l
    assert sep_r > 25.0, sep_r
    assert float(pil) > 1e-3


def test_wfm_mono_fallback():
    """Without a pilot the decoder degrades to mono (L == R)."""
    t = np.arange(int(0.1 * WFM_FS)) / WFM_FS
    mono = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    l, r, _pil = tdemod.wfm_stereo_decode(torch.from_numpy(mono), WFM_FS)
    # no 38 kHz content -> L-R is ~0 and both channels equal mono/2
    np.testing.assert_allclose(l.numpy(), r.numpy(), atol=1e-3)
