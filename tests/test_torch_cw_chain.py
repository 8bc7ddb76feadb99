"""The slice as a whole: the port's CPU Receiver, then the port's Morse
decoder, against the JAX package's chain on the same input, at the full
width of the repository's two weak-signal decode checks.

- The weak-signal qualification (tests/test_weak.py::
  TestWeakSignalQualification): 96 kHz IQ, fft1 8192, 262,144 samples per
  step, AFC and the coherent detector, "CQ DX DE SM5BSZ" keyed at 20 WPM
  on a carrier drifting 0.5 Hz/s at -2 dB in 2500 Hz (seed 1000).  The
  port's baseband, which the decoder reads, is held to the JAX
  Receiver's step by step (1e-4), the AFC's status after every step
  exactly, and decode_morse_ml of the port's baseband must read the
  message exactly.
- The full-chain decode (tests/test_weak.py::TestMorse::
  test_full_chain_decode): fft1 2048, 65,536 samples per step, SSB at a
  700 Hz BFO, with the fused fft1 (the JAX package's Pallas kernel in
  interpret mode; on the CPU the port's wrapper runs the kernel's plain
  version) and with the plain FFT.  decode_morse must read the message
  from both packages' audio alike.

Bars: baseb 1e-4 (every float field but audio, as tests/
test_torch_chain.py holds them); audio 2.3e-4, the chain's, in every step
but, in the qualification, the step after which the AFC first reports
status 2: there the coherent detector's smoothed carrier, which rotates
with the drift the AFC has not yet taken out, passes within 1.8e-4 of
zero (0.2% of its median), its unit phasor is ill-conditioned, and two
correct float32 evaluations differ by 2.6e-4 in one audio sample; that
step is held to 1e-3 (ROADMAP.md, queue 3, "Held at a looser bar").  The
BFO's
phase argument reaches 3,000 rad over a step of 4,096 baseband samples,
where one float32 step is 2.4e-4 rad: the port rounds phase + dphi*n
once, as XLA's fused multiply-add does (ops/demod.py:bfo_ssb); rounded
twice it put the audio 1.22e-4 or 2.44e-4 off in every step from the
second on.
"""

import dataclasses

import numpy as np
import pytest

from linrad_tpu import RxParams as JaxRxParams
from linrad_tpu.params import Demod as JaxDemod
from linrad_tpu.pipeline import Receiver as JaxReceiver
from linrad_tpu.weak.cw import decode_morse as j_decode_morse
from linrad_tpu_torch import convert, derive_geometry
from linrad_tpu_torch.pipeline import Receiver
from linrad_tpu_torch.utils.host import to_numpy
from linrad_tpu_torch.weak.cw import decode_morse, decode_morse_ml, keyed_cw

BASEB_BAR = 1e-4
AUDIO_BAR = 2.3e-4
LOCK_STEP_AUDIO_BAR = 1e-3


def _max_rel(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return float(np.abs(a - b).max()
                 / max(np.abs(a).max(), np.abs(b).max(), 1e-30))


def _both(jp, iq, tune_hz):
    """The JAX and the port Receiver (device "cpu") over iq, with the
    AFC's status after each step: (jax outputs, port outputs, statuses)."""
    jrx = JaxReceiver(jp)
    trx = Receiver(convert.params_from_jax(jp), device="cpu")
    jrx.tune(tune_hz)
    trx.tune(tune_hz)
    jo, to, status = [], [], []
    for j, t in zip(jrx.run(iq), trx.run(iq)):
        jo.append(j)
        to.append(t)
        if jrx.afc is not None:
            status.append((jrx.afc.status, trx.afc.status))
    return jo, to, status


def test_qualification_decodes_at_minus_2db():
    msg = "CQ DX DE SM5BSZ"
    fs, fc = 96000.0, 10_000.0
    jp = JaxRxParams(first_fft_bandwidth=30.0,
                     mix1_bandwidth_reduction_n=4, agc_enable=False,
                     afc_enable=True, demod=JaxDemod.COHERENT,
                     bfo_hz=600.0, filter_low_hz=-100.0,
                     filter_high_hz=100.0)
    geo = derive_geometry(convert.params_from_jax(jp))
    assert (geo.fft1_size, geo.samples_per_step) == (8192, 262_144)
    key = keyed_cw(msg, fs, 20.0, 0.0)
    n = (len(key) // geo.samples_per_step + 2) * geo.samples_per_step
    sig = np.zeros(n, np.complex64)
    sig[:len(key)] = key
    t = np.arange(n) / fs
    clean = sig * np.exp(2j * np.pi * (fc * t + 0.25 * t ** 2))
    sigma = np.sqrt(1.0 / (2 * (2500 / fs) * 10 ** (-2.0 / 10)))
    rng = np.random.default_rng(1000)
    iq = (clean + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
          ).astype(np.complex64)

    jo, to, status = _both(jp, iq, fc)
    assert all(a == b for a, b in status), status
    lock = [j for j, _ in status].index(2)
    for i, (j, t) in enumerate(zip(jo, to)):
        assert _max_rel(t.baseb, j.baseb) <= BASEB_BAR, i
        bar = LOCK_STEP_AUDIO_BAR if i == lock else AUDIO_BAR
        assert _max_rel(t.audio, j.audio) <= bar, i
    bb = np.concatenate([to_numpy(o.baseb) for o in to])[:, 0]
    assert decode_morse_ml(bb, geo.baseband_sampling_speed).text == msg


@pytest.mark.parametrize("variant", ["pallas", "xla"])
def test_full_chain_decode(variant):
    msg = "CQ CQ DE SM5BSZ"
    jp = JaxRxParams(first_fft_bandwidth=100.0,
                     mix1_bandwidth_reduction_n=4, agc_enable=False,
                     bfo_hz=700.0, filter_low_hz=-400.0,
                     filter_high_hz=400.0)
    jp = dataclasses.replace(jp, fft1_variant=variant)
    geo = derive_geometry(convert.params_from_jax(jp))
    assert (geo.fft1_size, geo.samples_per_step) == (2048, 65_536)
    cw = keyed_cw(msg, geo.rx_ad_speed, 20, 12_000.0)
    pad = ((len(cw) // geo.samples_per_step + 1) * geo.samples_per_step
           - len(cw))
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    rng = np.random.default_rng(1)
    cw = cw + 0.02 * (rng.normal(size=len(cw))
                      + 1j * rng.normal(size=len(cw))).astype(np.complex64)

    jo, to, _ = _both(jp, cw, 12_000.0)
    for i, (j, t) in enumerate(zip(jo, to)):
        assert _max_rel(t.baseb, j.baseb) <= BASEB_BAR, i
        assert _max_rel(t.audio, j.audio) <= AUDIO_BAR, i
    fs_bb = geo.baseband_sampling_speed
    audio = np.concatenate([to_numpy(o.audio) for o in to])[:, 0]
    ref = np.concatenate([np.asarray(o.audio) for o in jo])[:, 0]
    got = decode_morse(audio, fs_bb)
    assert got.text == j_decode_morse(ref, fs_bb).text == msg
    assert got.wpm == pytest.approx(20, rel=0.2)
