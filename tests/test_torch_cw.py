"""The port's weak/cw.py (Morse decoding, keying analysis, repeat
stacking) against the JAX package's, which it copies.

Both are numpy on the host, so the bar is equality: arrays bit for bit,
every field of a DecodeResult (text, speed, threshold, marks, score)
exactly.  Each function is also given a torch tensor of the same input
(the receiver's outputs are tensors) and must return what it returns for
the numpy array.  The cases mirror tests/test_weak.py's TestMorse,
TestEME.test_keying_spectrum_peak and TestStackedDecode.

decode_morse_ml without a speed hint tries about 70 speed and scorer
hypotheses (15-20 s a call here), so it runs unhinted on one short
recording only; the tensor cases and the stacked decodes take the hint.
"""

import numpy as np
import pytest
import torch

from linrad_tpu.weak import cw as jcw
from linrad_tpu_torch.weak import cw as tcw

FS = 6000.0


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(a, b) -> None:
    """Two DecodeResults, field for field."""
    assert type(a).__name__ == type(b).__name__ == "DecodeResult"
    assert a.text == b.text
    assert a.wpm == b.wpm and a.threshold == b.threshold
    assert a.score == b.score
    assert [tuple(map(int, m)) for m in a.marks] \
        == [tuple(map(int, m)) for m in b.marks]


def _noisy(msg: str, wpm: float, sigma: float, seed: int,
           fs: float = FS, tone_hz: float = 600.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cw = jcw.keyed_cw(msg, fs, wpm, tone_hz)
    return cw + sigma * (rng.normal(size=len(cw))
                         + 1j * rng.normal(size=len(cw)))


def test_tables_equal():
    assert tcw.MORSE_TABLE == jcw.MORSE_TABLE
    assert tcw.MORSE_ENCODE == jcw.MORSE_ENCODE


@pytest.mark.parametrize("complex_out", [True, False])
def test_keyed_cw_bit_equal(complex_out):
    args = ("CQ TEST DE SM5BSZ K", FS, 22, 600.0)
    kw = dict(amplitude=0.7, rise_s=0.004, complex_out=complex_out)
    got, ref = tcw.keyed_cw(*args, **kw), jcw.keyed_cw(*args, **kw)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wpm", [12, 20, 35])
def test_speed_detection(wpm):
    cw = jcw.keyed_cw("PARIS PARIS PARIS PARIS", FS, wpm, 600.0)
    env = np.abs(cw)
    est = tcw.detect_cw_speed(env, FS)
    assert est == jcw.detect_cw_speed(env, FS)
    assert est == pytest.approx(wpm, rel=0.25)
    assert tcw.detect_cw_speed(_t(env), FS) == est


def test_smooth_envelope_and_keying_spectrum():
    z = _noisy("EEEEEEEEEE", 24, 0.05, seed=2)
    env = tcw.smooth_envelope(z, FS, 60.0)
    np.testing.assert_array_equal(env, jcw.smooth_envelope(z, FS, 60.0))
    np.testing.assert_array_equal(tcw.smooth_envelope(_t(z), FS, 60.0), env)
    freqs, spec = tcw.keying_spectrum(np.abs(z), FS)
    jf, js = jcw.keying_spectrum(np.abs(z), FS)
    np.testing.assert_array_equal(freqs, jf)
    np.testing.assert_array_equal(spec, js)
    tf, ts = tcw.keying_spectrum(_t(np.abs(z)), FS)
    np.testing.assert_array_equal(tf, freqs)
    np.testing.assert_array_equal(ts, spec)
    # TestEME.test_keying_spectrum_peak: the 'E' stream's 4-dot period
    f0 = freqs[np.argmax(spec[1:]) + 1]
    assert f0 == pytest.approx(1 / (4 * 1.2 / 24), rel=0.2)


@pytest.mark.parametrize("case", ["clean", "noisy", "real"])
def test_decode_morse(case):
    if case == "clean":
        msg, z = "CQ TEST DE SM5BSZ K", jcw.keyed_cw("CQ TEST DE SM5BSZ K",
                                                    FS, 22, 600.0)
    elif case == "noisy":
        msg, z = "CQ DX", _noisy("CQ DX", 18, 0.15, seed=3)
    else:
        msg = "TEST"
        z = jcw.keyed_cw(msg, FS, 20, 700.0, complex_out=False)
    got = tcw.decode_morse(z, FS)
    _same(got, jcw.decode_morse(z, FS))
    assert got.text == msg
    _same(tcw.decode_morse(_t(z), FS), got)
    _same(tcw.decode_morse(_t(z), FS, wpm_hint=got.wpm),
          jcw.decode_morse(z, FS, wpm_hint=got.wpm))


def test_decode_morse_ml_unhinted():
    """The whole hypothesis search (speeds, aliases, the coherent
    scorer, the refinement) on a short noisy complex recording."""
    z = _noisy("CQ DX", 18, 0.3, seed=5)
    got = tcw.decode_morse_ml(z, FS)
    _same(got, jcw.decode_morse_ml(z, FS))
    assert got.text == "CQ DX"


@pytest.mark.parametrize("kind", ["complex", "envelope"])
def test_decode_morse_ml_hinted_on_a_tensor(kind):
    z = _noisy("CQ TEST DE SM5BSZ K", 22, 0.2, seed=6)
    if kind == "envelope":
        z = np.abs(z)
    got = tcw.decode_morse_ml(_t(z), FS, wpm_hint=22.0)
    _same(got, tcw.decode_morse_ml(z, FS, wpm_hint=22.0))
    _same(got, jcw.decode_morse_ml(z, FS, wpm_hint=22.0))
    assert got.text == "CQ TEST DE SM5BSZ K"


def test_learn_keying_ramp_and_ideal_waveform():
    """TestMorse.test_learn_keying_ramp_and_ideal_waveform on both."""
    rng = np.random.default_rng(0)
    cw = jcw.keyed_cw("CQ CQ DE SM5BSZ", FS, 18, 0.0, rise_s=0.008)
    noisy = cw + 0.05 * (rng.normal(size=len(cw))
                         + 1j * rng.normal(size=len(cw)))
    res = tcw.decode_morse(noisy, FS)
    env = np.abs(noisy)
    ramp = tcw.learn_keying_ramp(env, FS, 1.2 / res.wpm, res.marks)
    np.testing.assert_array_equal(
        ramp, jcw.learn_keying_ramp(env, FS, 1.2 / res.wpm, res.marks))
    np.testing.assert_array_equal(
        tcw.learn_keying_ramp(_t(env), FS, 1.2 / res.wpm, res.marks), ramp)
    assert ramp[0] < 0.1 and ramp[-1] > 0.9
    assert np.all(np.diff(ramp) >= 0)
    for r in (ramp, None):
        ideal = tcw.make_ideal_waveform(".-.- /-", FS, 18, r)
        np.testing.assert_array_equal(
            ideal, jcw.make_ideal_waveform(".-.- /-", FS, 18, r))
    np.testing.assert_array_equal(
        tcw.make_ideal_waveform(".-.- /-", FS, 18, _t(ramp)),
        tcw.make_ideal_waveform(".-.- /-", FS, 18, ramp))


def test_coherent_integrate():
    z = _noisy("CQ", 20, 0.1, seed=8, tone_hz=0.0)
    phase = np.full(len(z), 0.4)
    for cp in (None, phase):
        got = tcw.coherent_integrate(z, FS, 0.06, cp)
        np.testing.assert_array_equal(
            got, jcw.coherent_integrate(z, FS, 0.06, cp))
        np.testing.assert_array_equal(
            tcw.coherent_integrate(_t(z), FS, 0.06,
                                   None if cp is None else _t(cp)), got)


class TestStackedDecode:
    """tests/test_weak.py::TestStackedDecode on both packages: the repeat
    period found blind and refined, the stacks, and their decodes."""

    FS = 4000.0
    TEXT = "CQ DE SM5BSZ"

    def _recording(self, reps, snr_db, seed=4):
        sig = jcw.keyed_cw(self.TEXT, self.FS, 15.0, tone_hz=0.0)
        period = int(len(sig) + 2.0 * self.FS)
        one = np.zeros(period, np.complex64)
        one[:len(sig)] = sig
        z = np.tile(one, reps)
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(10 ** (-snr_db / 10) / 2500.0 * self.FS / 2)
        return (z + sigma * (rng.standard_normal(len(z))
                             + 1j * rng.standard_normal(len(z))),
                period / self.FS)

    def test_blind_coherent_stack_at_minus_12db(self):
        z, true_p = self._recording(24, -12)
        env = tcw.smooth_envelope(np.abs(z), self.FS, 30.0)
        p = tcw.estimate_repeat_period(env, self.FS, min_s=3.0)
        assert p == jcw.estimate_repeat_period(env, self.FS, min_s=3.0)
        assert tcw.estimate_repeat_period(_t(env), self.FS, min_s=3.0) == p
        p2 = tcw.refine_repeat_period(z, self.FS, p)
        assert p2 == jcw.refine_repeat_period(z, self.FS, p)
        assert tcw.refine_repeat_period(_t(z), self.FS, p, search=20) \
            == tcw.refine_repeat_period(z, self.FS, p, search=20)
        assert abs(p2 - true_p) < 0.002
        for coherent in (True, False):
            st = tcw.stack_repeats(z, self.FS, p2, coherent=coherent)
            np.testing.assert_array_equal(
                st, jcw.stack_repeats(z, self.FS, p2, coherent=coherent))
            np.testing.assert_array_equal(
                tcw.stack_repeats(_t(z), self.FS, p2, coherent=coherent), st)
        r = tcw.decode_stacked(z, self.FS, p2, wpm_hint=15.0, coherent=True)
        _same(r, jcw.decode_stacked(z, self.FS, p2, wpm_hint=15.0,
                                    coherent=True))
        _same(tcw.decode_stacked(_t(z), self.FS, p2, wpm_hint=15.0,
                                 coherent=True), r)
        assert self.TEXT in r.text

    def test_incoherent_stack_helps_without_phase(self):
        z, true_p = self._recording(16, -8)
        per = int(true_p * self.FS)
        rng = np.random.default_rng(7)
        blocks = z[: 16 * per].reshape(16, per).copy()
        blocks *= np.exp(2j * np.pi * rng.random(16))[:, None]
        z = blocks.reshape(-1)
        p = tcw.refine_repeat_period(z, self.FS, true_p, search=30)
        assert p == jcw.refine_repeat_period(z, self.FS, true_p, search=30)
        stacked = tcw.decode_stacked(z, self.FS, p, wpm_hint=15.0)
        _same(stacked, jcw.decode_stacked(z, self.FS, p, wpm_hint=15.0))
        single = tcw.decode_morse_ml(np.abs(z), self.FS, wpm_hint=15.0)
        _same(single, jcw.decode_morse_ml(np.abs(z), self.FS,
                                          wpm_hint=15.0))

        import difflib

        def edit(a, b):
            return 1.0 - difflib.SequenceMatcher(None, a, b).ratio()

        best = min(edit(self.TEXT, stacked.text[i:i + len(self.TEXT)])
                   for i in range(max(len(stacked.text)
                                      - len(self.TEXT) + 1, 1)))
        assert best < 0.35, (stacked.text, best)
        assert best < edit(self.TEXT, single.text[:len(self.TEXT)])
