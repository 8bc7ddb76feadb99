"""The port's transmit chain (tx/keying.py, modulate.py, ssbproc.py,
stream.py) against the JAX package's.

keying, modulate and ssbproc are numpy copies: arrays bit for bit, on
numpy input and on a torch tensor of it.  stream.py's file streamer and
delay model are host numpy too (bit for bit, delays exactly);
SsbTxStreamer runs its rational resampler on a torch device, here
device="cpu", against the JAX streamer's resampler on the JAX CPU device:
every D/A block within 1e-5 of the block's largest magnitude (float32
weighted sums taken in another order), every delay exactly.  The cases
mirror tests/test_tx_pol.py (TestKeying, TestModulators,
TestSSBProcessor) and tests/test_tx_stream.py.
"""

import numpy as np
import pytest
import torch

from linrad_tpu.io.wav import write_wav
from linrad_tpu.tx import keying as jkey
from linrad_tpu.tx import modulate as jmod
from linrad_tpu.tx import ssbproc as jssb
from linrad_tpu.tx import stream as jstream
from linrad_tpu.weak.cw import decode_morse as j_decode_morse
from linrad_tpu_torch import tx as ttx
from linrad_tpu_torch.tx import keying as tkey
from linrad_tpu_torch.tx import modulate as tmod
from linrad_tpu_torch.tx import ssbproc as tssb
from linrad_tpu_torch.tx import stream as tstream
from linrad_tpu_torch.weak.cw import decode_morse

FS = 48_000
BLOCK = 1024
STREAM_BAR = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, ref) -> None:
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_public_names():
    from linrad_tpu import tx as jtx
    assert ttx.__all__ == jtx.__all__
    for name in ttx.__all__:
        assert getattr(ttx, name).__module__.startswith("linrad_tpu_torch.")


# ---- keying ----------------------------------------------------------

def test_ascii_keying_decodes():
    fs = 8000.0
    key = tkey.ascii_keying("TEST", fs, 20)
    _eq(key, jkey.ascii_keying("TEST", fs, 20))
    env = tkey.cw_envelope(key, fs)
    _eq(env, jkey.cw_envelope(key, fs))
    _eq(tkey.cw_envelope(_t(key), fs), env)
    res = decode_morse(env.astype(np.complex64), fs)
    assert res.text == j_decode_morse(env.astype(np.complex64), fs).text \
        == "TEST"


def test_rise_time_and_pilot():
    fs = 48_000.0
    key = np.zeros(48_000, np.float32)
    key[10_000:20_000] = 1.0
    for rise in (0.0005, 0.005):
        _eq(tkey.cw_envelope(key, fs, rise_s=rise),
            jkey.cw_envelope(key, fs, rise_s=rise))
    _eq(tkey.pilot_tone(fs, 4096, 6000.0, 0.3, start=17),
        jkey.pilot_tone(fs, 4096, 6000.0, 0.3, start=17))


def test_radar_train_and_gating():
    fs = 96_000.0
    tx = tkey.radar_pulse_train(fs, prf_hz=100.0, pulse_s=0.001,
                                duration_s=1.0)
    _eq(tx, jkey.radar_pulse_train(fs, prf_hz=100.0, pulse_s=0.001,
                                   duration_s=1.0))
    rx = np.roll(tx, int(0.002 * fs)).astype(np.complex64)
    gates = tkey.range_gate(rx, fs, 100.0, 48)
    _eq(gates, jkey.range_gate(rx, fs, 100.0, 48))
    _eq(tkey.range_gate(_t(rx), fs, 100.0, 48), gates)
    assert 9 <= int(np.argmax(gates)) <= 15


# ---- modulate --------------------------------------------------------

@pytest.mark.parametrize("n", [8192, 8191])
def test_modulators(n):
    fs = 8000.0
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 700 * t) + 0.3 * np.sin(2 * np.pi * 1300 * t)
    for usb in (True, False):
        z = tmod.ssb_modulate(audio, fs, usb=usb)
        _eq(z, jmod.ssb_modulate(audio, fs, usb=usb))
        _eq(tmod.ssb_modulate(_t(audio), fs, usb=usb), z)
    _eq(tmod.am_modulate(audio, depth=0.5), jmod.am_modulate(audio, 0.5))
    _eq(tmod.am_modulate(_t(audio), 0.5), jmod.am_modulate(audio, 0.5))
    _eq(tmod.fm_modulate(audio, fs, 3000.0),
        jmod.fm_modulate(audio, fs, 3000.0))
    _eq(tmod.fm_modulate(_t(audio), fs, 3000.0),
        jmod.fm_modulate(audio, fs, 3000.0))
    # TestModulators.test_ssb_single_sided
    z = tmod.ssb_modulate(audio, fs, usb=True)
    spec = np.abs(np.fft.fft(z))
    f = np.fft.fftfreq(len(z), 1 / fs)
    assert 20 * np.log10(spec[(f > 600) & (f < 800)].max()
                         / spec[(f < -600) & (f > -800)].max()) > 40


def test_streaming_ssb():
    t_ssb, j_ssb = tmod.StreamingSSB(512), jmod.StreamingSSB(512)
    rng = np.random.default_rng(4)
    for _ in range(4):
        x = rng.normal(size=512)
        _eq(t_ssb.process(x), j_ssb.process(x))
    assert t_ssb.delay_samples == j_ssb.delay_samples == 256


# ---- ssbproc ---------------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(),
    dict(filter_low_hz=300.0, filter_high_hz=2700.0, bass_db=6.0,
         treble_db=-3.0, clip_db=6.0, shift_hz=150.0),
])
def test_ssb_processor(params):
    fs = 8000.0
    tp = tssb.SSBProcessor(fs, tssb.SSBProcParams(**params))
    jp = jssb.SSBProcessor(fs, jssb.SSBProcParams(**params))
    t = np.arange(16_384) / fs
    quiet = 0.01 * np.sin(2 * np.pi * 800 * t[:8192])
    loud = 1.0 * np.sin(2 * np.pi * 800 * t[8192:])
    x = np.concatenate([quiet, loud])
    out = tp.process(x)
    _eq(out, jp.process(x))
    _eq(tp.process(_t(x[:4096])), jp.process(x[:4096]))
    if not params:                   # TestSSBProcessor.test_agc_levels
        rms_q = np.sqrt(np.mean(out[2000:8000] ** 2))
        rms_l = np.sqrt(np.mean(out[10_000:] ** 2))
        assert abs(20 * np.log10(rms_l / rms_q)) < 6.0


# ---- stream ----------------------------------------------------------

@pytest.fixture
def iq_wav(tmp_path):
    """A short IQ file: a pure tone, 3.5 blocks long (forces looping)."""
    n = int(3.5 * BLOCK)
    iq = (1000.0 * np.exp(2j * np.pi * 1000.0 / FS * np.arange(n))
          ).astype(np.complex64)
    path = str(tmp_path / "tx.wav")
    write_wav(path, iq, FS, bits=16)
    return path, iq


def test_source_header_checks_and_loop(iq_wav):
    path, iq = iq_wav
    for mod in (tstream, jstream):
        with pytest.raises(mod.TxFormatError):
            mod.WavTxSource(path, expect_rate=96_000)
        with pytest.raises(mod.TxFormatError):
            mod.WavTxSource(path, expect_channels=4)
    src = tstream.WavTxSource(path, expect_rate=FS, expect_channels=2)
    ref = jstream.WavTxSource(path, expect_rate=FS, expect_channels=2)
    for _ in range(9):
        _eq(src.read_block(BLOCK), ref.read_block(BLOCK))
    assert src.loops == ref.loops == 2 and src.pos == ref.pos


def test_streamer_prefill_pilot_and_delay(iq_wav):
    path, _ = iq_wav
    kw = dict(fs=FS, block=BLOCK, ring_blocks=8, pilot_hz=6000.0,
              pilot_level=500.0)
    tx = tstream.TxStreamer(tstream.WavTxSource(path), **kw)
    ref = jstream.TxStreamer(jstream.WavTxSource(path), **kw)
    assert tx.total_delay() == ref.total_delay() \
        == pytest.approx(6 * BLOCK / FS)
    got, want = [], []
    tx.run(8, got.append)
    ref.run(8, want.append)
    for a, b in zip(got, want):
        _eq(a, b)
    assert tx.total_delay() == ref.total_delay()
    for mod in (tstream, jstream):
        with pytest.raises(ValueError):
            mod.TxStreamer(mod.WavTxSource(path), fs=FS, block=BLOCK,
                           ring_blocks=6)


def test_stage_buffer_accounting():
    s = tstream.StageBuffer("x", 1000.0)
    s.written += 500
    s.read += 100
    assert s.occupancy == 400 and s.delay_s == pytest.approx(0.4)


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max()
                 / max(np.abs(a).max(), np.abs(b).max(), 1e-30))


def test_ssb_streamer_against_jax():
    """tests/test_tx_stream.py::test_ssb_streamer_delay_and_spectrum on
    the port's streamer (device "cpu") beside the JAX one: the same
    delays at every point, the D/A blocks within 1e-5, the mic pushed
    once as numpy and once as a torch tensor."""
    fs_ad, fs_da = 12_000, 48_000
    tx = tstream.SsbTxStreamer(fs_ad, fs_da, block=1024, device="cpu")
    ref = jstream.SsbTxStreamer(fs_ad, fs_da, block=1024)
    assert tx.resampler.device.type == "cpu"
    mic = np.sin(2 * np.pi * 700.0 / fs_ad * np.arange(6 * 1024)
                 ).astype(np.float32)

    tx.push_mic(_t(mic[: 3 * 1024]))
    ref.push_mic(mic[: 3 * 1024])
    assert tx.total_delay() == ref.total_delay() \
        == pytest.approx(3 * 1024 / fs_ad + 1024 / fs_ad)
    tx.pump()
    ref.pump()
    assert tx.mic.occupancy == 0 and tx.txout.occupancy == 3 * 4096
    assert tx.total_delay() == ref.total_delay()
    tx.push_mic(mic)
    ref.push_mic(mic)
    tx.pump()
    ref.pump()
    blocks = []
    while (b := tx.pop_dac()) is not None:
        want = ref.pop_dac()
        assert b.dtype == want.dtype == np.complex64
        assert b.shape == want.shape == (4096,)
        assert _max_rel(b, want) <= STREAM_BAR
        blocks.append(b)
    assert ref.pop_dac() is None and len(blocks) == 9
    assert tx.total_delay() == ref.total_delay() \
        == pytest.approx(1024 / fs_ad)
    # USB: energy at +700 Hz, the image rejected
    out = np.concatenate(blocks[3:])
    spec = np.abs(np.fft.fft(out[4096:] * np.hanning(len(out) - 4096)))
    freqs = np.fft.fftfreq(len(out) - 4096, 1.0 / fs_da)
    kp = np.argmin(np.abs(freqs - 700.0))
    km = np.argmin(np.abs(freqs + 700.0))
    assert spec[kp] > 30 * spec[km]


def test_ssb_streamer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.SsbTxStreamer(12_000, 48_000, block=1024)
