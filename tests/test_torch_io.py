"""The port's own copies of the JAX package's host modules that import no
jax (errors, io.wav, io.siggen, io.rawfile, runtime with lrt.cpp,
runtime.watchdog) against the originals.  Everything here is host Python,
numpy and C++, so the bar is equality: files byte for byte, arrays bit for
bit, the watchdog's verdicts under a fake clock exactly.
"""

import dataclasses
import time

import numpy as np
import pytest

from linrad_tpu import errors as jerrors
from linrad_tpu import runtime as jruntime
from linrad_tpu.io import rawfile as jraw
from linrad_tpu.io import siggen as jsig
from linrad_tpu.io import wav as jwav
from linrad_tpu.runtime import watchdog as jwd
from linrad_tpu_torch import errors as terrors
from linrad_tpu_torch import runtime as truntime
from linrad_tpu_torch.io import rawfile as traw
from linrad_tpu_torch.io import siggen as tsig
from linrad_tpu_torch.io import wav as twav
from linrad_tpu_torch.runtime import watchdog as twd


def _iq(n: int, channels: int, scale: float, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (scale * (rng.normal(size=(n, channels))
                     + 1j * rng.normal(size=(n, channels)))
            ).astype(np.complex64)


# ---- errors -----------------------------------------------------------

def test_error_catalog_equal():
    assert terrors.ERROR_TEXT == jerrors.ERROR_TEXT
    assert terrors.LirError is not jerrors.LirError


@pytest.mark.parametrize("code", [9005, 9006, 9007, 123456])
def test_lirerr(code):
    with pytest.raises(terrors.LirError) as t:
        terrors.lirerr(code, "extra")
    with pytest.raises(jerrors.LirError) as j:
        jerrors.lirerr(code, "extra")
    assert t.value.code == j.value.code == code
    assert str(t.value) == str(j.value)


# ---- io.wav -----------------------------------------------------------

WAV_CASES = {
    "pcm8-unsupported": dict(bits=8),
    "pcm16-iq": dict(bits=16),
    "pcm16-iq2": dict(bits=16, channels=2),
    "pcm24-iq": dict(bits=24),
    "float32-iq": dict(bits=32),
    "pcm32-iq2": dict(bits=32, pcm32=True, channels=2),
    "pcm16-rcvr": dict(bits=16, rcvr=dict(center_frequency_hz=14_100_000)),
    "pcm16-auxi": dict(bits=16, auxi=dict(center_freq=7_040_000)),
}


@pytest.mark.parametrize("case", list(WAV_CASES))
def test_wav_round_trip(case, tmp_path):
    """write_wav of both packages gives the same bytes; each package's
    read_wav gives the same samples and the same WavInfo from either
    file."""
    kw = dict(WAV_CASES[case])
    channels = kw.pop("channels", 1)
    scale = 1e6 if kw.get("pcm32") else 1000.0
    data = _iq(700, channels, scale)
    jkw, tkw = dict(kw), dict(kw)
    if "rcvr" in kw:
        jkw["rcvr"] = jwav.RcvrChunk(**kw["rcvr"])
        tkw["rcvr"] = twav.RcvrChunk(**kw["rcvr"])
    if "auxi" in kw:
        jkw["auxi"] = jwav.AuxiChunk(**kw["auxi"])
        tkw["auxi"] = twav.AuxiChunk(**kw["auxi"])
    jp, tp = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    if kw["bits"] == 8:
        for mod, path in ((jwav, jp), (twav, tp)):
            with pytest.raises(ValueError, match="unsupported bits"):
                mod.write_wav(path, data, 96_000, bits=8)
        return
    jwav.write_wav(jp, data, 96_000, **jkw)
    twav.write_wav(tp, data, 96_000, **tkw)
    raw = open(tp, "rb").read()
    assert raw == open(jp, "rb").read()
    jx, jinfo = jwav.read_wav(jp)
    tx, tinfo = twav.read_wav(tp)
    assert type(tinfo) is twav.WavInfo
    assert tx.dtype == jx.dtype and tx.shape == jx.shape == (700, channels)
    np.testing.assert_array_equal(tx, jx)
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    if "rcvr" in kw:
        assert tinfo.rcvr.center_frequency_hz == 14_100_000
        assert tinfo.rcvr.pack() == jinfo.rcvr.pack()
    if "auxi" in kw:
        assert tinfo.auxi.center_freq == 7_040_000
        assert tinfo.auxi.pack() == jinfo.auxi.pack()
    # the channels as written, not paired to IQ
    tr, _ = twav.read_wav(tp, return_iq=False)
    jr, _ = jwav.read_wav(jp, return_iq=False)
    np.testing.assert_array_equal(tr, jr)
    assert tr.shape == (700, 2 * channels)


# ---- io.siggen --------------------------------------------------------

def test_siggen_constants_and_fields():
    assert (tsig.IG_CF1, tsig.IG_CF2) == (jsig.IG_CF1, jsig.IG_CF2)
    for name in ("Tone", "InternalGenerator"):
        j, t = getattr(jsig, name), getattr(tsig, name)
        assert [(f.name, f.default) for f in dataclasses.fields(j)] == \
            [(f.name, f.default) for f in dataclasses.fields(t)]


@pytest.mark.parametrize("start", [0, 12_345])
def test_tones_iq(start):
    tones = [dict(freq_hz=10_200.0), dict(freq_hz=-3_000.5, amplitude=0.3,
                                          phase=1.1),
             dict(freq_hz=700.0, key_period_s=0.01, key_duty=0.4)]
    a = tsig.tones_iq(96_000, 5000, [tsig.Tone(**t) for t in tones], start)
    b = jsig.tones_iq(96_000, 5000, [jsig.Tone(**t) for t in tones], start)
    assert a.dtype == b.dtype == np.complex64
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsig.tones_iq(96_000, 64, [tsig.Tone(100.0)], dtype=np.complex128),
        jsig.tones_iq(96_000, 64, [jsig.Tone(100.0)], dtype=np.complex128))


@pytest.mark.parametrize("fn", ["gaussian", "gaussian_real", "impulse",
                                "impulse_wide"])
def test_noise_generators(fn):
    def draw(mod):
        rng = np.random.default_rng(21)
        if fn == "gaussian":
            return mod.gaussian_noise(rng, 4000, 6.0)
        if fn == "gaussian_real":
            return mod.gaussian_noise(rng, 4000, 3.0, complex_out=False)
        width = 5 if fn == "impulse_wide" else 1
        return mod.impulse_noise(rng, 20_000, 500.0, 96_000.0, 300.0, width)
    a, b = draw(tsig), draw(jsig)
    assert a.dtype == b.dtype and np.abs(a).max() > 0
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels,noise", [(1, 0), (2, 5)])
def test_internal_generator(channels, noise):
    tg = tsig.InternalGenerator(96_000.0, channels, noise)
    jg = jsig.InternalGenerator(96_000.0, channels, noise)
    for n in (1000, 333):
        a, b = tg(n), jg(n)
        assert a.shape == (n, channels)
        np.testing.assert_array_equal(a, b)
    assert tg.sample_index == jg.sample_index == 1333


# ---- runtime: packers, ring, prefetcher -------------------------------

def test_native_library_is_built_outside_the_package():
    """g++ is here, so the library loads; it lies under build/, named by a
    hash of lrt.cpp, and the package directory holds no binary."""
    assert truntime.get_lib() is not None
    so = truntime._lib_path()
    assert so.exists() and so.parent == truntime.BUILD_DIR
    assert so.parent.name == "linrad_tpu_torch"
    assert so.parent.parent.name == "build"
    pkg = truntime._SRC.parent
    assert not list(pkg.glob("*.so")) and not list(pkg.glob("*.tmp"))


def test_lrt_source_is_the_original_up_to_comments():
    def code(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.lstrip().startswith("//")]
    assert code(truntime._SRC) == code(jruntime._SRC)


@pytest.fixture(params=["native", "numpy"])
def runtime_mode(request, monkeypatch):
    """The port's runtime with its C++ library, and in its numpy and
    Python-thread mode (no compiler)."""
    if request.param == "numpy":
        monkeypatch.setattr(truntime, "get_lib", lambda: None)
    else:
        assert truntime.get_lib() is not None
    return request.param


def test_packers(runtime_mode):
    rng = np.random.default_rng(5)
    x = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=4096, dtype=np.int64
                     ).astype(np.int32)
    for name in ("pack18", "pack24"):
        a = getattr(truntime, name)(x)
        b = getattr(jruntime, name)(x)
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=name)
    p18, p24 = jruntime.pack18(x), jruntime.pack24(x)
    np.testing.assert_array_equal(truntime.expand18(p18),
                                  jruntime.expand18(p18))
    np.testing.assert_array_equal(truntime.expand24(p24),
                                  jruntime.expand24(p24))
    # 18 bits kept, bit 13 set as the half-bit dither
    np.testing.assert_array_equal(truntime.expand18(p18),
                                  (x & ~0x3FFF) | 0x2000)
    np.testing.assert_array_equal(truntime.expand24(p24), x & ~0xFF)
    i16 = rng.integers(-32768, 32767, size=1000).astype(np.int16)
    np.testing.assert_array_equal(truntime.i16_to_f32(i16, 0.25),
                                  jruntime.i16_to_f32(i16, 0.25))


def test_ring(runtime_mode):
    ring = truntime.Ring(1 << 12)
    data = bytes(range(256)) * 8
    assert ring.write(data[:1000]) == 1000
    assert ring.write(data[1000:]) == len(data) - 1000
    assert ring.read(700) == data[:700]
    assert ring.read(500) == data[700:1200]
    ring.close()
    assert ring.read(4096) == data[1200:]       # short read after close
    assert ring.read(16) == b""


def test_file_prefetcher(runtime_mode, tmp_path):
    rng = np.random.default_rng(6)
    body = rng.integers(0, 256, size=10_000, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(b"HEADER--" + body)
    pf = truntime.FilePrefetcher(str(path), block_bytes=4096, offset=8)
    assert (pf._h is not None) == (runtime_mode == "native")
    got = [pf.read_block() for _ in range(4)]
    assert [len(g) for g in got] == [4096, 4096, 10_000 - 8192, 0]
    assert b"".join(got) == body
    jpf = jruntime.FilePrefetcher(str(path), block_bytes=4096, offset=8)
    assert b"".join(jpf.read_block() for _ in range(3)) == body


# ---- io.rawfile -------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [16, 18, 24])
def test_rawfile_round_trip(bits, channels, tmp_path, runtime_mode):
    iq = _iq(1001, channels, 0.2)
    jp, tp = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    jraw.write_raw(jp, iq, 96_000, bits=bits, center_freq_hz=14.1e6)
    traw.write_raw(tp, iq, 96_000, bits=bits, center_freq_hz=14.1e6)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jx, jinfo = jraw.read_raw(jp)
    tx, tinfo = traw.read_raw(tp)
    assert type(tinfo) is traw.RawInfo
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    np.testing.assert_array_equal(tx, jx)
    # truncation to the kept bits, on both parts of a complex sample
    assert np.max(np.abs(tx[:1001] - iq)) < 2.0 ** (2 - min(bits, 18))


def test_rawfile_headerless_and_bad_bits(tmp_path):
    iq = _iq(64, 1, 0.2)
    path = str(tmp_path / "h.raw")
    open(path, "wb").write(
        (np.stack([iq.real, iq.imag], -1) * 32767).astype("<i2").tobytes())
    info = dict(sample_rate=48_000, channels=1, bits=16)
    with pytest.raises(ValueError, match="no LTPURAW1 header"):
        traw.read_raw(path)
    tx, _ = traw.read_raw(path, headerless=traw.RawInfo(**info),
                          full_scale=1.0)
    jx, _ = jraw.read_raw(path, headerless=jraw.RawInfo(**info),
                          full_scale=1.0)
    np.testing.assert_array_equal(tx, jx)
    with pytest.raises(ValueError, match="bits must be"):
        traw.write_raw(path, iq, 48_000, bits=12)


# ---- runtime.watchdog -------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


WD = {"port": (twd, terrors.LirError), "jax": (jwd, jerrors.LirError)}


def _watchdog_story(mod, err) -> list:
    """One scripted life of the three classes; everything they said."""
    said = []
    c = mod.OverrunCounter("RX")
    said.append(c.record(480))
    c.record(480)
    said.append((c.events, c.units_lost))
    c.raise_if_over(5)
    with pytest.raises(err) as e:
        c.raise_if_over(1)
    said.append((e.value.code, str(e.value)))
    clk = FakeClock()
    wd = mod.Watchdog(timeout_s=1.0, clock=clk)
    wd.beat("fft1")
    wd.beat("blanker")
    clk.t = 0.5
    wd.beat("fft1")
    said.append(wd.stalled())
    clk.t = 1.4
    said.append(wd.stalled())
    with pytest.raises(err) as e:
        wd.check()
    said.append((e.value.code, str(e.value)))
    wd.beat("blanker")
    wd.check()
    wd.remove("fft1")
    clk.t = 10.0
    said.append(wd.stalled())
    clk.t = 0.0
    m = mod.RealTimeMonitor(rate_hz=96000, headroom_s=0.25, clock=clk)
    said.append(m.behind())
    m.advance(96000)
    clk.t = 0.5
    said.append((m.margin_s, m.stream_s, m.samples))
    m.check()
    clk.t = 1.5
    said.append((m.margin_s, m.behind()))
    with pytest.raises(err) as e:
        m.check()
    said.append((e.value.code, str(e.value)))
    return said


def test_watchdog_copy_says_what_the_original_says():
    port = _watchdog_story(*WD["port"])
    assert port == _watchdog_story(*WD["jax"])
    assert port[0] == "RX overrun error 1" and port[1] == (2, 960)
    assert port[2][0] == 9006 and port[5][0] == 9005 and port[10][0] == 9007
    assert port[3] == [] and port[4] == ["blanker"] and port[6] == ["blanker"]
    assert port[8][0] == pytest.approx(0.75) and port[9] == (
        pytest.approx(-0.25), True)


def test_watchdog_background_thread_reports_once():
    wd = twd.Watchdog(timeout_s=0.05)
    hits = []
    wd.beat("rx")
    wd.start(hits.append, interval_s=0.02)
    try:
        time.sleep(0.2)
    finally:
        wd.stop()
    assert hits == [["rx"]]    # one transition report, not a flood
