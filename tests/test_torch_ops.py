"""Each module of the port's receive path against its JAX counterpart.

Inputs come from numpy with fixed seeds and go to both packages.  Max
relative error is max|a-b| / max(max|a|, max|b|) per array (as
tools/tpu_parity.py measures it).  Tolerances, with their reasons:

- EXACT: integer and boolean results, counts, classifications, and data
  movement (framing, segment reductions of integer-valued inputs).
- FP32: 1e-5 — both sides compute the same fp32 formula but may sum or
  transform in another order (pocketfft vs ducc, scan vs cummax/matmul).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import derive_geometry
from linrad_tpu.ops import agc as jagc
from linrad_tpu.ops import blanker as jbl
from linrad_tpu.ops import demod as jdemod
from linrad_tpu.ops import fft as jfft
from linrad_tpu.ops import fft2 as jfft2
from linrad_tpu.ops import fft3 as jfft3
from linrad_tpu.ops import framing as jframing
from linrad_tpu.ops import mix1 as jmix1
from linrad_tpu.ops import mix2 as jmix2
from linrad_tpu.ops import sellim as jsellim
from linrad_tpu.ops import timf2 as jtimf2
from linrad_tpu.utils import scanops as jscan
from linrad_tpu.utils import segments as jseg
from linrad_tpu_torch import RxParams as TRxParams
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import agc as tagc
from linrad_tpu_torch.ops import blanker as tbl
from linrad_tpu_torch.ops import demod as tdemod
from linrad_tpu_torch.ops import fft as tfft
from linrad_tpu_torch.ops import fft2 as tfft2
from linrad_tpu_torch.ops import fft3 as tfft3
from linrad_tpu_torch.ops import framing as tframing
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.ops import mix2 as tmix2
from linrad_tpu_torch.ops import sellim as tsellim
from linrad_tpu_torch.ops import timf2 as ttimf2
from linrad_tpu_torch.utils import scanops as tscan
from linrad_tpu_torch.utils import segments as tseg

FP32 = 1e-5
CPU = "cpu"


def _rel(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    a = a.astype(np.complex128)
    b = b.astype(np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _cnoise(rng, shape, scale=1.0):
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


GEOS = {"tiny": derive_geometry(_flagship_params(tiny=True)),
        "flagship": derive_geometry(_flagship_params())}
# the port's own Geometry for the same configurations
T_GEOS = {"tiny": t_derive_geometry(convert.params_from_jax(
              _flagship_params(tiny=True))),
          "flagship": t_derive_geometry(convert.params_from_jax(
              _flagship_params()))}


# ---- framing ---------------------------------------------------------

@pytest.mark.parametrize("frame,hop,chans", [(256, 128, 1), (512, 128, 2),
                                             (256, 96, 1)])
def test_framing(frame, hop, chans):
    """frame_stream and overlap_add match JAX exactly (data movement and
    the same summation order), hop dividing the frame or not, and both
    are block-split invariant: one block of 2S == two blocks of S."""
    rng = np.random.default_rng(1)
    s = 4 * hop
    tail = _cnoise(rng, (frame - hop, chans))
    block = _cnoise(rng, (2 * s, chans))
    f_t, nt_t = tframing.frame_stream(_t(tail), _t(block), frame, hop)
    f_j, nt_j = jframing.frame_stream(jnp.asarray(tail), jnp.asarray(block),
                                      frame, hop)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(nt_t.numpy(), np.asarray(nt_j))
    fa, ta = tframing.frame_stream(_t(tail), _t(block[:s]), frame, hop)
    fb, tb = tframing.frame_stream(ta, _t(block[s:]), frame, hop)
    assert torch.equal(torch.cat([fa, fb]), f_t) and torch.equal(tb, nt_t)

    carry = _cnoise(rng, (frame - hop, chans))
    o_t, c_t = tframing.overlap_add(f_t, hop, _t(carry))
    o_j, c_j = jframing.overlap_add(f_j, hop, jnp.asarray(carry))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    n2 = f_t.shape[0] // 2
    oa, ca = tframing.overlap_add(f_t[:n2], hop, _t(carry))
    ob, cb = tframing.overlap_add(f_t[n2:], hop, ca)
    assert _rel(torch.cat([oa, ob]).numpy(), o_t.numpy()) <= 1e-6
    assert _rel(cb.numpy(), c_t.numpy()) <= 1e-6


# ---- fft -------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_fft(inverse):
    rng = np.random.default_rng(2)
    x = _cnoise(rng, (6, 512, 2))
    t_fn = tfft.ifft if inverse else tfft.fft
    j_fn = jfft.ifft if inverse else jfft.fft
    assert _rel(t_fn(_t(x), axis=1).numpy(),
                j_fn(jnp.asarray(x), axis=1)) <= FP32
    # the matmul DFTs along a middle axis (four-step at 512: 16 x 32),
    # against JAX's: fp32 within FP32; bf16 operands within FP32 of it
    # too, both sides rounding the same operands and summing exact
    # products in fp32 (tests/test_torch_mxu.py has the rest)
    for v in ("mxu", "mxu_bf16"):
        assert _rel(t_fn(_t(x), axis=1, variant=v).numpy(),
                    j_fn(jnp.asarray(x), axis=1, variant=v)) <= FP32
    with pytest.raises(ValueError):
        t_fn(_t(x), axis=1, variant="bogus")


# ---- segments --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments(seed):
    """Segmented max/min/sum on integer-valued inputs: exact."""
    rng = np.random.default_rng(seed)
    n = 257
    vals = rng.integers(-50, 50, size=n).astype(np.float32)
    mask = rng.random(n) < 0.6
    mask[0] = seed == 1
    mask[-1] = seed != 2
    for t_fn, j_fn in ((tseg.segment_max, jseg.segment_max),
                       (tseg.segment_min, jseg.segment_min),
                       (tseg.segment_sum, jseg.segment_sum)):
        np.testing.assert_array_equal(
            t_fn(_t(vals), _t(mask)).numpy(),
            np.asarray(j_fn(jnp.asarray(vals), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        tseg.segment_starts(_t(mask)).numpy(),
        np.asarray(jseg.segment_starts(jnp.asarray(mask))))


# ---- sellim ----------------------------------------------------------

def _spectrum(rng, n, step):
    """Averaged power spectrum: noise floor, two strong signals with
    skirts (positive liminfo), moderate carriers (-1 bins) that move."""
    p = 1e3 * rng.chisquare(4, size=n) / 4
    k = np.arange(n)
    for centre, height, width in ((n // 5 + step, 3e9, 1.5),
                                  (3 * n // 4, 5e7, 0.7)):
        p += height * np.exp(-0.5 * ((k - centre) / width) ** 2)
    for centre in (n // 3 + 2 * step, n // 2 + 7, n - 9):
        p[centre % n] += 8e4 * (1 + step)
    return p.astype(np.float32)


@pytest.mark.parametrize("geo_name", ["tiny", "flagship"])
def test_sellim(geo_name):
    """update_liminfo over 5 successive updates (smoothing, hold timer
    and release cap all engage): liminfo sign pattern and liminfo_wait
    exact, values <= 1e-5; liminfo_gains exact on the same liminfo."""
    geo = GEOS[geo_name]
    tgeo = T_GEOS[geo_name]
    n = geo.fft1_size
    rng = np.random.default_rng(5)
    j_st = jsellim.SellimState.create(geo)
    t_st = tsellim.SellimState.create(tgeo, CPU)
    upd = jax.jit(lambda s, p, lo, hi: jsellim.update_liminfo(
        geo, s, p, 8.0, ston=30.0, sel_lo=lo, sel_hi=hi))
    strong_seen = neg_seen = False
    for step in range(5):
        p = _spectrum(rng, n, step)
        if step == 3:
            p[n // 5 - 3: n // 5 + 8] = 1e3   # the strong signal leaves
        lo, hi = n // 8, n // 8 + 6
        j_st = upd(j_st, jnp.asarray(p), jnp.int32(lo), jnp.int32(hi))
        t_st = tsellim.update_liminfo(tgeo, t_st, _t(p), 8.0, ston=30.0,
                                      sel_lo=torch.tensor(lo),
                                      sel_hi=torch.tensor(hi))
        jl = np.asarray(j_st.liminfo)
        tl = t_st.liminfo.numpy()
        np.testing.assert_array_equal(np.sign(tl), np.sign(jl))
        np.testing.assert_array_equal(t_st.liminfo_wait.numpy(),
                                      np.asarray(j_st.liminfo_wait))
        assert t_st.liminfo_wait.dtype == torch.int32
        assert _rel(tl, jl) <= FP32
        strong_seen |= bool((jl > 0).any())
        neg_seen |= bool((jl < 0).any())
        for a, b in zip(tsellim.liminfo_gains(t_st.liminfo),
                        jsellim.liminfo_gains(j_st.liminfo)):
            assert _rel(a.numpy(), b) <= FP32
    assert strong_seen and neg_seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chain_reach(seed):
    """The two-cummax closed form equals the JAX associative scan."""
    rng = np.random.default_rng(seed)
    strong = rng.random(200) < 0.05
    q = rng.random(200) < 0.7
    for reverse in (False, True):
        np.testing.assert_array_equal(
            tsellim._chain_reach(_t(strong), _t(q), reverse).numpy(),
            np.asarray(jsellim._chain_reach(jnp.asarray(strong),
                                            jnp.asarray(q), reverse)))


# ---- timf2 -----------------------------------------------------------

def test_timf2():
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    rng = np.random.default_rng(6)
    n, big = geo.fft1_frames_per_step, geo.fft1_size
    lim = np.zeros(big, np.float32)
    lim[10:14] = -1.0
    lim[40:45] = 0.3
    j_st = jtimf2.Timf2State.create(geo)
    t_st = ttimf2.Timf2State.create(tgeo, CPU)
    j_syn = jtimf2.make_timf2_syn(geo)
    t_syn = ttimf2.make_timf2_syn(tgeo, CPU)
    np.testing.assert_array_equal(t_syn.numpy(), np.asarray(j_syn))
    wg, sg = jsellim.liminfo_gains(jnp.asarray(lim))
    for _ in range(2):
        spec = _cnoise(rng, (n, big, 1), 30.0)
        j_st, jw, js, jp = jtimf2.timf2_step(geo, j_syn, j_st,
                                             jnp.asarray(spec), wg, sg)
        t_st, tw, ts, tp = ttimf2.timf2_step(tgeo, t_syn, t_st, _t(spec),
                                             _t(wg), _t(sg))
        for a, b in ((tw, jw), (ts, js), (tp, jp),
                     (t_st.weak_carry, j_st.weak_carry),
                     (t_st.strong_carry, j_st.strong_carry)):
            assert _rel(a.numpy(), b) <= FP32


# ---- blanker ---------------------------------------------------------

def _pulses(geo, rng, n_pulses, amp=300.0):
    """Weak stream: complex noise plus bank-shaped pulses."""
    s = geo.samples_per_step
    bank, _pf, pw = jbl.make_refpulse_bank(np.ones(geo.fft1_size), 64)
    x = _cnoise(rng, (s, 1), 3.0)[:, 0].astype(np.complex128)
    for pos in rng.integers(40, s - 40, size=n_pulses):
        row = bank[rng.integers(0, bank.shape[0])]
        a = amp * rng.uniform(0.5, 1.5) * np.exp(2j * np.pi * rng.random())
        lo = pos - 32
        x[lo: lo + 64] += a * row
    weak = x.astype(np.complex64)[:, None]
    pwr = (np.abs(weak[:, 0]) ** 2).astype(np.float32)
    return weak, pwr, pw


@pytest.mark.parametrize("block_size,geo_name,n_pulses",
                         [(256, "tiny", 12), (0, "tiny", 12),
                          (256, "flagship", 90), (0, "flagship", 30)])
def test_clever_blanker(block_size, geo_name, n_pulses):
    """Fitted count exact; weak' and pwr' within fp32 of JAX."""
    geo = GEOS[geo_name]
    tgeo = T_GEOS[geo_name]
    rng = np.random.default_rng(8)
    weak, pwr, pw = _pulses(geo, rng, n_pulses)
    j_tab, _ = jbl.BlankerTables.create(geo)
    t_tab, t_pw = tbl.BlankerTables.create(tgeo, CPU)
    assert t_pw == pw
    max_pulses = 64 if geo_name == "flagship" else 8
    nf = np.float32(18.0)
    jw, jp, jn = jax.jit(lambda w, p, f: jbl.clever_blanker(
        w, p, j_tab, f, 6.0, pw, max_pulses, block_size=block_size))(
            jnp.asarray(weak), jnp.asarray(pwr), jnp.asarray(nf))
    tw, tp, tn = tbl.clever_blanker(_t(weak), _t(pwr), t_tab,
                                    torch.tensor(nf), 6.0, pw, max_pulses,
                                    block_size=block_size)
    assert int(tn) == int(jn) > 0
    assert tn.dtype == torch.int32
    assert _rel(tw.numpy(), jw) <= FP32
    assert _rel(tp.numpy(), jp) <= FP32


@pytest.mark.parametrize("seed", [0, 1])
def test_stupid_blanker_and_noise_floor(seed):
    """Cleared count and the cleared samples exact; noise floor fp32."""
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    rng = np.random.default_rng(seed)
    weak, pwr, pw = _pulses(geo, rng, 10, amp=100.0)
    nf = np.float32(18.0)
    jw, jp, jn = jbl.stupid_blanker(jnp.asarray(weak), jnp.asarray(pwr),
                                    jnp.asarray(nf), 4.0, pw)
    tw, tp, tn = tbl.stupid_blanker(_t(weak), _t(pwr), torch.tensor(nf),
                                    4.0, pw)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    step_s = geo.samples_per_step / geo.timf1_sampling_speed
    j_nf = jbl.update_noise_floor(jbl.BlankerState.create(geo),
                                  jnp.asarray(pwr), step_s)
    t_nf = tbl.update_noise_floor(tbl.BlankerState.create(tgeo, CPU),
                                  _t(pwr), step_s)
    assert _rel(t_nf.noise_floor.numpy(), j_nf.noise_floor) <= 1e-6
    assert _rel(tbl.despiked_mean(_t(pwr)).numpy(),
                jbl.despiked_mean(jnp.asarray(pwr))) <= 1e-6


# ---- fft2, fft3 ------------------------------------------------------

def test_fft2():
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    rng = np.random.default_rng(9)
    j_tab, t_tab = jfft2.FFT2Tables.create(geo), tfft2.FFT2Tables.create(
        tgeo, CPU)
    j_st, t_st = jfft2.FFT2State.create(geo), tfft2.FFT2State.create(tgeo, CPU)
    for _ in range(2):
        weak = _cnoise(rng, (geo.samples_per_step, 1))
        strong = _cnoise(rng, (geo.samples_per_step, 1), 5.0)
        jt, js = jfft2.fft2_transform(geo, j_tab, j_st.tail,
                                      jnp.asarray(weak), jnp.asarray(strong))
        tt, ts = tfft2.fft2_transform(tgeo, t_tab, t_st.tail, _t(weak),
                                      _t(strong))
        assert _rel(ts.numpy(), js) <= FP32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        j_st, jp = jfft2.fft2_power_update(geo, j_st, jt, js, 8)
        t_st, tp = tfft2.fft2_power_update(tgeo, t_st, tt, ts, 8)
        assert _rel(tp.numpy(), jp) <= FP32
        assert _rel(t_st.sumsq_avg.numpy(), j_st.sumsq_avg) <= FP32


def test_fft3():
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    rng = np.random.default_rng(10)
    j_tab, t_tab = jfft3.FFT3Tables.create(geo), tfft3.FFT3Tables.create(
        tgeo, CPU)
    j_st, t_st = jfft3.FFT3State.create(geo), tfft3.FFT3State.create(tgeo, CPU)
    for _ in range(2):
        x = _cnoise(rng, (geo.fft3_frames_per_step * geo.fft3_new_points, 1))
        j_st, js = jfft3.fft3_step(geo, j_tab, j_st, jnp.asarray(x))
        t_st, ts = tfft3.fft3_step(tgeo, t_tab, t_st, _t(x))
        assert _rel(ts.numpy(), js) <= FP32
        np.testing.assert_array_equal(t_st.tail.numpy(),
                                      np.asarray(j_st.tail))


# ---- mix1, mix2 ------------------------------------------------------

@pytest.mark.parametrize("center,frac", [(66, None), (66, 0.37),
                                         (511, -0.45), (3, 0.0)])
def test_mix1(center, frac):
    """Three steps so the integer phase and the fractional phase carry:
    phase_idx exact, timf3 and carries fp32."""
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    rng = np.random.default_rng(11)
    j_tab, t_tab = jmix1.Mix1Tables.create(geo), tmix1.Mix1Tables.create(
        tgeo, CPU)
    j_st, t_st = jmix1.Mix1State.create(geo), tmix1.Mix1State.create(tgeo, CPU)
    jf = None if frac is None else jnp.float32(frac)
    tf = None if frac is None else torch.tensor(frac, dtype=torch.float32)
    for _ in range(3):
        spec = _cnoise(rng, (geo.fftx_frames_per_step, geo.fftx_size, 1),
                       10.0)
        j_st, jy = jmix1.mix1_step(geo, j_tab, j_st, jnp.asarray(spec),
                                   jnp.int32(center), tune_frac=jf)
        t_st, ty = tmix1.mix1_step(tgeo, t_tab, t_st, _t(spec),
                                   torch.tensor(center), tune_frac=tf)
        assert _rel(ty.numpy(), jy) <= FP32
        assert int(t_st.phase_idx) == int(j_st.phase_idx)
        assert t_st.phase_idx.dtype == torch.int32
        assert _rel(t_st.ola_carry.numpy(), j_st.ola_carry) <= FP32
        assert abs(float(t_st.frac_phase) - float(j_st.frac_phase)) <= 1e-6


def test_mix2():
    geo = GEOS["tiny"]
    tgeo = T_GEOS["tiny"]
    p = _flagship_params(tiny=True)
    rng = np.random.default_rng(12)
    j_tab = jmix2.Mix2Tables.create(geo, p)
    t_tab = tmix2.Mix2Tables.create(tgeo, convert.params_from_jax(p),
                                     CPU)
    j_st, t_st = jmix2.Mix2State.create(geo), tmix2.Mix2State.create(tgeo, CPU)
    for _ in range(2):
        spec = _cnoise(rng, (geo.fft3_frames_per_step, geo.fft3_size, 1))
        j_st, jb, _ = jmix2.mix2_step(geo, j_tab, j_st, jnp.asarray(spec))
        t_st, tb, tc = tmix2.mix2_step(tgeo, t_tab, t_st, _t(spec))
        assert tc is None
        assert _rel(tb.numpy(), jb) <= FP32
        assert _rel(t_st.ola_carry.numpy(), j_st.ola_carry) <= FP32


# ---- scanops, agc, demod ---------------------------------------------

@pytest.mark.parametrize("n,a", [(4096, 0.944), (4096, 0.99995), (64, 0.9),
                                 (37, 0.5), (5000, 0.999)])
def test_one_pole(n, a):
    """Blocked scan vs the JAX associative scan, two blocks streamed."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0.1, 100.0, size=(2, n, 2)).astype(np.float32)
    j_y0 = jnp.asarray([1.0, 3.0], jnp.float32)
    t_y0 = torch.tensor([1.0, 3.0])
    aj = jnp.float32(a)
    for blk in x:
        jy, j_y0 = jscan.one_pole(jnp.asarray(blk), aj, j_y0)
        ty, t_y0 = tscan.one_pole(_t(blk), a, t_y0)
        assert _rel(ty.numpy(), jy) <= FP32
        assert _rel(t_y0.numpy(), j_y0) <= FP32


@pytest.mark.parametrize("decay", [0.99954, 0.9, 0.5])
def test_decay_max(decay):
    rng = np.random.default_rng(14)
    x = rng.exponential(size=(2, 4096, 1)).astype(np.float32)
    x[0, 100] = 1e4
    j_y0 = jnp.asarray([50.0], jnp.float32)
    t_y0 = torch.tensor([50.0])
    for blk in x:
        jy, j_y0 = jscan.decay_max(jnp.asarray(blk), jnp.float32(decay),
                                   j_y0)
        ty, t_y0 = tscan.decay_max(_t(blk), float(np.float32(decay)), t_y0)
        assert _rel(ty.numpy(), jy) <= FP32


@pytest.mark.parametrize("window", [1, 2, 5, 64, 100])
def test_sliding_max(window):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(300, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tscan.sliding_max(_t(x), window).numpy(),
        np.asarray(jscan.sliding_max(jnp.asarray(x), window)))


@pytest.mark.parametrize("hang_ms", [0.0, 20.0])
def test_agc(hang_ms):
    rng = np.random.default_rng(16)
    fs = 6000.0
    j_st, t_st = jagc.AGCState.create(1), tagc.AGCState.create(1, CPU)
    for k in range(3):
        x = (rng.normal(size=(4096, 1)) * (1 + 30 * (k == 1))).astype(
            np.float32)
        j_st, jo, jg = jagc.agc(j_st, jnp.asarray(x), fs, 2.0, 250.0,
                                hang_ms)
        t_st, to, tg = tagc.agc(t_st, _t(x), fs, 2.0, 250.0, hang_ms)
        for a, b in ((to, jo), (tg, jg), (t_st.env, j_st.env),
                     (t_st.gain, j_st.gain)):
            assert _rel(a.numpy(), b) <= FP32


def test_bfo_ssb():
    rng = np.random.default_rng(17)
    j_st, t_st = jdemod.BFOState.create(), tdemod.BFOState.create(CPU)
    for _ in range(3):
        z = _cnoise(rng, (4096, 1))
        j_st, ja = jdemod.bfo_ssb(j_st, jnp.asarray(z), 800.0, 6000.0)
        t_st, ta = tdemod.bfo_ssb(t_st, _t(z), 800.0, 6000.0)
        assert _rel(ta.numpy(), ja) <= FP32
        assert abs(float(t_st.phase) - float(j_st.phase)) <= 1e-5


def test_unported_fft1_input_refused():
    """Real input, which fft1_step used to refuse, now runs: 2N real
    samples per frame give an N-bin spectrum, and "pallas" takes the
    torch.fft path without launching the fused kernel."""
    p = convert.params_from_jax(dataclasses.replace(
        _flagship_params(tiny=True), input_mode=0))
    geo = t_derive_geometry(p)
    from linrad_tpu_torch.ops import fft1 as tfft1
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    tables = tfft1.FFT1Tables.create(geo, "cpu")
    state = tfft1.FFT1State.create(geo, "cpu")
    assert tables.window.shape == (2 * geo.fft1_size,)
    assert state.tail.dtype == torch.float32
    block = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2 * geo.samples_per_step, 1)).astype(np.float32))
    before = fused_fft1.launches
    _st, spec, power = tfft1.fft1_step(geo, tables, state, block, 8,
                                       variant="pallas")
    assert fused_fft1.launches == before
    assert spec.shape == (geo.fft1_frames_per_step, geo.fft1_size, 1)
    assert spec.dtype == torch.complex64 and float(power.sum()) > 0
    assert isinstance(p, TRxParams)
