"""The operator's views and outputs of the port: viz.py (waterfall,
meters, Allan deviation, image dumps), io/taps.py (UDP taps and the TCP
control server), io/publish.py (the taps as a Receiver hook, the WAV
exports) and io/httpd.py (the web GUI), against the JAX package's.

These are host numpy and the standard library in both packages, so the
bar is equality: arrays bit for bit, files and HTTP bodies byte for
byte.  Each array entry point is also given a torch tensor (the port's
Receiver hands its hooks tensors) and must do what it does with the
numpy array.  Network traffic stays on 127.0.0.1: the port's taps meet at
a unicast loopback address (``dest=``/``bind=``, port 0 picks a free
one).  The cases mirror tests/test_viz_modes.py, tests/test_publish.py,
tests/test_httpd.py and tests/test_runtime_io.py's tap cases.
"""

import dataclasses
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from linrad_tpu import viz as jviz
from linrad_tpu.io import httpd as jhttpd
from linrad_tpu.io import publish as jpub
from linrad_tpu.io import taps as jtaps
from linrad_tpu_torch import RxParams
from linrad_tpu_torch import viz as tviz
from linrad_tpu_torch.io import httpd as thttpd
from linrad_tpu_torch.io import publish as tpub
from linrad_tpu_torch.io import taps as ttaps
from linrad_tpu_torch.io.siggen import Tone, tones_iq
from linrad_tpu_torch.pipeline import Receiver

LOOP = "127.0.0.1"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, ref) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _get(port, path):
    with urllib.request.urlopen(f"http://{LOOP}:{port}{path}",
                                timeout=5) as r:
        return r.read(), r.headers.get("Content-Type")


# ---- viz -------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True])
def test_waterfall(as_tensor):
    wfs = (tviz.Waterfall(n_bins=128, depth=4, avg_steps=2),
           jviz.Waterfall(n_bins=128, depth=4, avg_steps=2))
    rng = np.random.default_rng(0)
    for i in range(10):
        p = (10.0 ** (i / 2) * rng.random((128, 2))).astype(np.float32)
        wfs[0].add(_t(p) if as_tensor else p)
        wfs[1].add(p)
    _eq(wfs[0].array_db, wfs[1].array_db)
    _eq(wfs[0].image(), wfs[1].image())
    assert wfs[0].array_db.shape == (4, 128)


def test_spectrum_meters_allan():
    p = np.array([1.0, 100.0, 3e-40], np.float32)
    _eq(tviz.spectrum_db(p, ref=2.0), jviz.spectrum_db(p, ref=2.0))
    _eq(tviz.spectrum_db(_t(p)), jviz.spectrum_db(p))
    for pw in (10 ** (-73 / 10), 10 ** (-97 / 10), 1e-7, 0.0):
        assert tviz.s_meter_dbm(pw, 3.0) == jviz.s_meter_dbm(pw, 3.0)
    assert tviz.s_meter_dbm(10 ** (-97 / 10))[1] == "S5"
    rng = np.random.default_rng(0)
    y = rng.normal(size=1 << 14)
    for taus in (None, np.array([1.0, 4.0, 9.0])):
        got = tviz.allan_deviation(y, tau0_s=1.0, taus=taus)
        ref = jviz.allan_deviation(y, tau0_s=1.0, taus=taus)
        _eq(got[0], ref[0])
        _eq(got[1], ref[1])
        got_t = tviz.allan_deviation(
            _t(y), 1.0, None if taus is None else _t(taus))
        _eq(got_t[1], got[1])
    taus, adev = tviz.allan_deviation(y, tau0_s=1.0)
    assert adev[3] / adev[1] == pytest.approx((taus[1] / taus[3]) ** 0.5,
                                              rel=0.2)


def test_correlation_and_oscilloscope():
    rng = np.random.default_rng(1)
    common = rng.normal(size=(32, 256)) + 1j * rng.normal(size=(32, 256))
    s = np.stack([common, common], axis=-1).astype(np.complex64)
    s[..., 1] += 0.1 * rng.normal(size=(32, 256))
    _eq(tviz.correlation_spectrum(s), jviz.correlation_spectrum(s))
    _eq(tviz.correlation_spectrum(_t(s)), jviz.correlation_spectrum(s))
    pwr = np.ones(1000, np.float32)
    pwr[700] = 100.0
    weak = (np.arange(1000) + 0j).astype(np.complex64)
    for args in ((weak, pwr), (_t(weak), _t(pwr))):
        cap = tviz.oscilloscope_capture(*args, window=64)
        ref = jviz.oscilloscope_capture(weak, pwr, window=64)
        assert cap.keys() == ref.keys()
        for k in cap:
            _eq(cap[k], ref[k])
    assert cap["maxpoint"] == 700 and len(cap["trace"]) == 64


def test_image_dumps(tmp_path):
    rng = np.random.default_rng(3)
    img = (np.cumsum(rng.integers(-3, 4, size=(90, 257)), axis=1)
           % 256).astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[:, 0] = np.arange(256)
    for name, save, args in (("pgm", "save_pgm", ()),
                             ("gif", "save_gif", ()),
                             ("pal.gif", "save_gif", (pal,))):
        paths = [tmp_path / f"{who}.{name}" for who in ("t", "tt", "j")]
        getattr(tviz, save)(str(paths[0]), img, *args)
        getattr(tviz, save)(str(paths[1]), _t(img),
                            *(_t(a) for a in args))
        getattr(jviz, save)(str(paths[2]), img, *args)
        assert paths[0].read_bytes() == paths[1].read_bytes() \
            == paths[2].read_bytes()
    assert (tmp_path / "t.gif").read_bytes()[:6] == b"GIF87a"


def test_smeter_logger(tmp_path):
    logs = [mod.SMeterLogger(str(tmp_path / f"{i}.txt"), step_seconds=0.5,
                             avg_steps=4) for i, mod in enumerate((tviz,
                                                                   jviz))]
    for k in range(10):
        for log in logs:
            log.add(1e-7 * (1 + k))
    lines = [(tmp_path / f"{i}.txt").read_text() for i in range(2)]
    assert lines[0] == lines[1] and len(lines[0].splitlines()) == 2


# ---- taps ------------------------------------------------------------

def test_taps_unicast_loopback():
    """A sender and a receiver meet at one loopback address; the stream
    and its headers arrive as the JAX package's sender would pack them."""
    rx = ttaps.TapReceiver(ttaps.TAP_BASEB, timeout=2.0, bind=(LOOP, 0))
    tx = ttaps.TapSender(ttaps.TAP_BASEB, dest=(LOOP, rx.port))
    tx.header.passband_center = 144.1
    assert rx.group == LOOP and rx.port > 0
    data = np.arange(ttaps.PAYLOAD_BYTES // 4 * 3, dtype=np.float32)
    assert tx.send(data[:100]) == 0           # partial payload stays
    assert tx.send(_t(data[100:])) == 3
    got = rx.recv_array(data.nbytes, np.float32)
    _eq(got, data)
    assert rx.last_block == 3 and rx.lost_packets == 0
    tx.send(data[:10])
    tx.flush()
    hdr, payload = rx.recv()
    assert hdr.block_no == 4 and hdr.passband_center == 144.1
    assert len(payload) == ttaps.PAYLOAD_BYTES
    tx.close()
    rx.close()
    # the wire format and tap codes are the JAX package's
    assert ttaps._HDR.format == jtaps._HDR.format
    assert ttaps.PAYLOAD_BYTES == jtaps.PAYLOAD_BYTES
    for fmt in range(8):
        assert ttaps.group_for(fmt) == jtaps.group_for(fmt)


def test_control_server_round_trip():
    srv = ttaps.ControlServer({"FREQ": lambda a: f"OK {float(a) * 2}"},
                              host=LOOP, port=0)
    try:
        assert ttaps.control_request("FREQ", "72.0", port=srv.port) \
            == "OK 144.0"
        assert ttaps.control_request("NOPE", port=srv.port) \
            == "ERR unknown"
        # the JAX package's client speaks to the port's server
        assert jtaps.control_request("FREQ", "1.5", port=srv.port) \
            == "OK 3.0"
    finally:
        srv.close()


# ---- publish ---------------------------------------------------------

def test_receiver_publishes_taps_bit_for_bit():
    """TestPublisher on the port's Receiver (device "cpu"): the audio and
    baseband taps carry the tensors' bytes; the stream is read after
    every step, as a slave reads it while the master runs."""
    p = RxParams(fft1_n_override=9, agc_enable=False,
                 target_fft1_frames_per_step=16)
    rx = Receiver(p, device="cpu")
    nets = {f: ttaps.TapReceiver(f, timeout=2.0, bind=(LOOP, 0))
            for f in (ttaps.TAP_BASEB, ttaps.TAP_BASEBRAW)}
    pub = tpub.TapPublisher({ttaps.TAP_BASEB: "audio",
                             ttaps.TAP_BASEBRAW: "baseb"},
                            passband_center_mhz=144.0,
                            dest={f: (LOOP, r.port) for f, r in nets.items()})
    pub.attach(rx)
    g = rx.geo
    rx.tune(10_000.0)
    iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 3, [Tone(10_200.0)])
    sent = {f: b"" for f in nets}
    got = {f: b"" for f in nets}
    for out in rx.run(iq):
        sent[ttaps.TAP_BASEB] += out.audio.numpy().tobytes()
        sent[ttaps.TAP_BASEBRAW] += out.baseb.numpy().tobytes()
        for f, net in nets.items():
            while len(got[f]) < pub.senders[f].block_no * \
                    ttaps.PAYLOAD_BYTES:
                hdr, payload = net.recv()
                assert hdr.passband_center == 144.0
                got[f] += payload
    for f in nets:
        n = len(got[f])
        assert n >= ttaps.PAYLOAD_BYTES and got[f] == sent[f][:n]
    pub.close()
    for net in nets.values():
        net.close()
    assert tpub.TapPublisher.DEFAULT == jpub.TapPublisher.DEFAULT


@pytest.mark.parametrize("export", ["spectravue", "perseus", "powersdr",
                                    "qs1r"])
def test_exports_byte_equal(tmp_path, export):
    iq = ((np.arange(512)[:, None] % 37 - 18) * (300 - 170j)
          ).astype(np.complex64)
    args = {"spectravue": (196_078, 14_100_000),
            "perseus": (250_000, 144_125_000), "powersdr": (96_000,),
            "qs1r": (250_000, 7_050_000)}[export]
    name = f"export_{export}_wav"
    files = []
    for who, mod, x in (("t", tpub, iq), ("tt", tpub, _t(iq)),
                        ("j", jpub, iq)):
        path = tmp_path / f"{who}.wav"
        getattr(mod, name)(str(path), x, *args)
        files.append(path.read_bytes())
    assert files[0] == files[1] == files[2]


# ---- httpd -----------------------------------------------------------

class _Out:
    """Minimal RxOutputs stand-in for the hook: numpy or tensors."""

    def __init__(self, n_bins=64, n_audio=128, rng=None, tensors=False):
        rng = rng or np.random.default_rng(0)
        self.fft1_power = rng.random((n_bins, 1)).astype(np.float32)
        self.fft2_power = None
        self.audio = (0.1 * rng.standard_normal((n_audio, 1))
                      ).astype(np.float32)
        if tensors:
            self.fft1_power = _t(self.fft1_power)
            self.audio = _t(self.audio)


def test_grayscale_bmp():
    for img in (np.arange(12, dtype=np.uint8).reshape(3, 4),
                np.zeros((2, 5), np.uint8), np.zeros((0, 0), np.uint8)):
        b = thttpd.grayscale_bmp(img)
        assert b == jhttpd.grayscale_bmp(img)
        assert thttpd.grayscale_bmp(_t(img)) == b
    assert thttpd._wav_bytes(np.zeros((3, 2), np.float32), 8000) \
        == jhttpd._wav_bytes(np.zeros((3, 2), np.float32), 8000)


def test_web_gui_endpoints_equal_jax():
    """Both GUIs fed the same five steps (the port's as tensors) answer
    every endpoint with the same bytes."""
    guis = [thttpd.WebGui(audio_rate=8000), jhttpd.WebGui(audio_rate=8000)]
    ports = [g.serve(host=LOOP) for g in guis]
    try:
        for tensors, g in zip((True, False), guis):
            rng = np.random.default_rng(1)
            for _ in range(5):
                g(None, _Out(rng=rng, tensors=tensors))
        for path in ("/", "/waterfall.bmp", "/spectrum.json",
                     "/status.json", "/audio.wav"):
            (a, ca), (b, cb) = (_get(p, path) for p in ports)
            assert (a, ca) == (b, cb), path
        bmp, ctype = _get(ports[0], "/waterfall.bmp")
        assert ctype == "image/bmp"
        assert struct.unpack("<ii", bmp[18:26]) == (64, 5)
        st = json.loads(_get(ports[0], "/status.json")[0])
        assert st["steps"] == 5 and st["audio_samples"] == 5 * 128
        with pytest.raises(urllib.error.HTTPError):
            _get(ports[0], "/nope")
    finally:
        for g in guis:
            g.close()


def test_web_gui_audio_stream_and_ring():
    g = thttpd.WebGui(audio_rate=8000)
    port = g.serve(host=LOOP)
    try:
        req = urllib.request.urlopen(f"http://{LOOP}:{port}/audio.stream",
                                     timeout=5)
        hdr = req.read(44)
        assert hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"
        out = _Out(n_audio=100, tensors=True)
        g(None, out)
        chunk = req.read(200)
        assert chunk == (np.clip(out.audio.numpy(), -1, 1) * 32767.0
                         ).astype("<i2").tobytes()
        req.close()
    finally:
        g.close()
    ring = thttpd.WebGui(audio_rate=1000, audio_keep_s=0.5)
    for _ in range(10):
        ring(None, _Out(n_audio=100))
    assert 500 <= ring.status()["audio_samples"] <= 600


def test_web_gui_on_a_port_receiver():
    """TestReceiverIntegration on the port's Receiver (device "cpu"): the
    GUI's waterfall holds the fft1 power the card (here the CPU) made."""
    p = RxParams(rx_ad_speed=96_000, first_fft_bandwidth=400.0,
                 second_fft_enable=False, blanker_enable=False,
                 agc_enable=False, fft1_n_override=9,
                 target_fft1_frames_per_step=8)
    rx = Receiver(p, device="cpu")
    gui = thttpd.WebGui()
    gui.attach(rx)
    port = gui.serve(host=LOOP)
    try:
        iq = tones_iq(96_000.0, 2 * rx.geo.samples_per_step,
                      [Tone(rx.tuned_hz, 0.5)])
        powers = [o.fft1_power.numpy() for o in rx.run(iq)]
        st = json.loads(_get(port, "/status.json")[0])
        assert st["steps"] == 2
        assert st["audio_rate"] == int(round(rx.geo.baseband_sampling_speed))
        bmp, _ = _get(port, "/waterfall.bmp")
        wf = jviz.Waterfall(n_bins=powers[0].shape[0])
        for pw in powers:
            wf.add(pw.sum(axis=-1))
        assert bmp == jhttpd.grayscale_bmp(wf.image())
    finally:
        gui.close()


def test_waterfall_dataclass_fields_equal():
    assert [f.name for f in dataclasses.fields(tviz.Waterfall)] \
        == [f.name for f in dataclasses.fields(jviz.Waterfall)]
