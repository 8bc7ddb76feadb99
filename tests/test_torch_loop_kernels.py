"""The two device loops of the main path that the port runs as hand-written
kernels on the card: the blocked clever blanker's sequential fits
(``ops/blanker.py:blanker_fits``, ``csrc/blanker_fits.cu``) and sellim's
edge taper (``ops/sellim.py:sellim_taper``, ``csrc/sellim_taper.cu``).

On the CPU each wrapper runs its plain version, so these tests hold:

- the wrappers, through ``clever_blanker`` and ``update_liminfo``, against
  the JAX package at full width (fitted counts and liminfo signs exact,
  floats within FP32: both sides compute the same float32 formulas in
  another order);
- the property both kernels' early exits rest on: once the blanker's best
  candidate is at or under the threshold, and once a taper pass changes no
  bin, every later iteration changes nothing, bit for bit;
- the vmap rules (one launch of R blocks on the card, the plain version
  per stream here) bit-equal to separate calls;
- a numpy model of the fits kernel's candidate index (active bits, the
  maxima of sub-blocks and of their groups, the rows a fit stages, the
  refresh), bit for bit against the plain version on ``chip_smoke.py``'s
  crafted cases, and the plain version against JAX on the tie, NaN and
  +inf cases;
- a numpy model of the taper kernel (tiles with halos, the closed form,
  the window loop where its precondition fails), bit for bit against the
  plain version on ``chip_smoke.py``'s crafted cases and on random ones,
  the precondition asserted on every call ``update_liminfo`` makes, and
  ``update_liminfo`` against JAX where it breaks the precondition (a
  +inf power bin, maxlevel 0);
- what the wrappers refuse, the stupid blanker's operator
  (``ops/blanker.py:blanker_clear``, ``csrc/blanker_clear.cu``) among them,
  whose numpy model is in ``tests/test_torch_blanker_clear.py``.

The kernels themselves run on the card only: ``chip_smoke.py``'s loop
kernel phase holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from __graft_entry__ import _flagship_params
from linrad_tpu import RxMode, derive_geometry, preset
from linrad_tpu.ops import blanker as jbl
from linrad_tpu.ops import sellim as jsellim
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import blanker as tbl
from linrad_tpu_torch.ops import fused_fft1 as tff
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.ops import sellim as tsellim
from linrad_tpu_torch.utils import cuda_build
from linrad_tpu_torch.weak import radar as trd

FP32 = 1e-5
CPU = "cpu"
S = 65_536                   # the flagship's samples per step
NOISE_FLOOR = np.float32(100.0)
LIMIT_AMP = 6.0              # the flagship's clever_bln_limit


def _rel(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


FLAGSHIP = _flagship_params()
GEO = derive_geometry(FLAGSHIP)
BANK, PHASEFUNC, PW = jbl.make_refpulse_bank(np.ones(GEO.fft1_size), 64)


def _weak_stream(seed: int, channels: int, n_pulses: int, impulses: int):
    """The weak channel as the blanker sees it at the flagship: noise of
    sigma 10, band-limited pulses of the reference bank's shape (the
    impulses after timf2) with a random amplitude, phase, sub-sample
    offset and, on two channels, polarization, and single-sample
    impulses of 3,000."""
    rng = np.random.default_rng(seed)
    x = 10.0 * (rng.normal(size=(S, channels))
                + 1j * rng.normal(size=(S, channels)))
    for pos in rng.integers(100, S - 100, size=n_pulses):
        row = BANK[rng.integers(0, BANK.shape[0])]
        amp = 3000.0 * rng.uniform(0.3, 1.5) \
            * np.exp(2j * np.pi * rng.random(channels))
        x[pos - 32: pos + 32] += row[:, None] * amp[None, :] \
            * (1.0 if channels == 1 else rng.uniform(0.2, 1.0, channels))
    pos = rng.integers(0, S, size=impulses)
    x[pos] += 3000.0 * np.exp(2j * np.pi * rng.random((impulses, channels)))
    weak = x.astype(np.complex64)
    pwr = (np.abs(weak) ** 2).sum(1).astype(np.float32)
    return weak, pwr


def _eligible() -> np.ndarray:
    """A time shard's mask: halos of 2,048 samples at both ends."""
    mask = np.ones(S, bool)
    mask[:2048] = mask[-2048:] = False
    return mask


# one JAX run per case: (channels, pulses, impulses, eligible)
BLANKER_CASES = {
    "flagship": (1, 40, 40, False),
    "two-channel": (2, 30, 20, False),
    "eligible": (1, 40, 40, True),
}
# fewer pulses, so that the candidates run out before the 64th fit
LIGHT_CASES = {
    "one-channel": (1, 10, 10, False),
    "two-channel": (2, 10, 5, False),
    "eligible": (1, 10, 10, True),
}


def _light_input(case: str):
    c, n_pulses, impulses, elig = LIGHT_CASES[case]
    weak, pwr = _weak_stream(5, c, n_pulses, impulses)
    return weak, pwr, _eligible() if elig else None


@pytest.fixture(scope="module")
def blanker_runs():
    j_tab = jbl.BlankerTables(refbank=jnp.asarray(BANK),
                              phasefunc=jnp.asarray(PHASEFUNC))
    runs = {}
    for name, (c, n_pulses, impulses, elig) in BLANKER_CASES.items():
        weak, pwr = _weak_stream(len(runs), c, n_pulses, impulses)
        eligible = _eligible() if elig else None

        def fn(w, p, f, e):
            return jbl.clever_blanker(w, p, j_tab, f, LIMIT_AMP, PW, 64,
                                      block_size=256, eligible=e)

        out = jax.jit(fn)(jnp.asarray(weak), jnp.asarray(pwr),
                          jnp.asarray(NOISE_FLOOR),
                          None if eligible is None else jnp.asarray(eligible))
        runs[name] = (weak, pwr, eligible,
                      tuple(np.asarray(x) for x in out))
    return runs


def _t_tables():
    return tbl.BlankerTables(refbank=_t(BANK), phasefunc=_t(PHASEFUNC))


def _assert_fits_contract(wpad, ppad, candp, bmax, *_rest):
    """blanker_fits' precondition (``_check_fits``), which the kernel rests
    on: candp is ppad where active and -1 elsewhere, ppad nowhere negative,
    bmax candp's block maxima; NaN where ppad's is."""
    assert not bool((ppad < 0).any())
    active = ~(candp < 0)
    assert torch.equal(torch.where(active, 0.0, candp),
                       torch.where(active, 0.0, -1.0))
    torch.testing.assert_close(candp[active], ppad[active], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(
        bmax, candp.reshape(bmax.shape[0], -1).amax(1), rtol=0, atol=0,
        equal_nan=True)


@pytest.fixture
def fits_contract(monkeypatch):
    """Every blanker_fits call of _clever_blanker_blocked checked against
    the precondition; yields a list with one entry a call."""
    calls = []
    fits = tbl.blanker_fits

    def checked(*args):
        _assert_fits_contract(*args)
        calls.append(1)
        return fits(*args)

    monkeypatch.setattr(tbl, "blanker_fits", checked)
    yield calls


@pytest.mark.parametrize("case", list(BLANKER_CASES))
def test_blanker_fits_against_jax(blanker_runs, case, fits_contract):
    """clever_blanker(block_size=256) through blanker_fits (its plain
    version on the CPU) against the JAX blocked blanker at 65,536 samples
    and 64 fits: nfit exact, weak and pwr within FP32; the arguments the
    caller builds meet the operator's precondition."""
    weak, pwr, eligible, (jw, jp, jn) = blanker_runs[case]
    tw, tp, tn = tbl.clever_blanker(
        _t(weak), _t(pwr), _t_tables(), torch.tensor(NOISE_FLOOR),
        LIMIT_AMP, PW, 64, block_size=256,
        eligible=None if eligible is None else _t(eligible))
    assert tn.dtype == torch.int32 and tn.shape == ()
    assert int(tn) == int(jn) > 10
    assert len(fits_contract) == 1
    assert tw.shape == weak.shape and tp.shape == pwr.shape
    assert _rel(tw.numpy(), jw) <= FP32
    assert _rel(tp.numpy(), jp) <= FP32


def _fits_args(weak, pwr, eligible=None, blk=256):
    """blanker_fits' arguments as _clever_blanker_blocked builds them."""
    s = weak.shape[0]
    pul = BANK.shape[1]
    lead = pul
    total = max(-(-(s + 2 * pul) // blk) * blk, 2 * blk)
    trail = total - s - lead
    wpad = tbl._pad_rows(_t(weak), lead, trail)
    ppad = tbl._pad_rows(_t(pwr), lead, trail)
    act = torch.ones(s, dtype=torch.bool) if eligible is None \
        else _t(eligible)
    active = tbl._pad_rows(act, lead, trail, False)
    candp = torch.where(active, ppad, -1.0)
    bmax = candp.reshape(total // blk, blk).amax(1)
    thr = tbl._threshold(LIMIT_AMP, torch.tensor(NOISE_FLOOR))
    return (wpad, ppad, candp, bmax, _t(BANK), _t(PHASEFUNC), thr), lead


@pytest.mark.parametrize("case", list(LIGHT_CASES))
def test_blanker_fits_stop_at_last_candidate(case, monkeypatch):
    """The kernel stops at the first iteration whose candidate is at or
    under the threshold.  In the plain version every iteration from there
    on is invalid and leaves the state as it was: with max_pulses at the
    count of valid iterations M, at M + 16 and at 64 the results are the
    same bits."""
    weak, pwr, eligible = _light_input(case)
    args, lead = _fits_args(weak, pwr, eligible)
    valid = []
    fit_subtract = tbl._fit_subtract

    def recording(wpad, ppad, tables, pw, p, ok):
        valid.append(bool(ok))
        return fit_subtract(wpad, ppad, tables, pw, p, ok)

    monkeypatch.setattr(tbl, "_fit_subtract", recording)
    full = tbl._blanker_fits_reference(*args, PW, 64, lead, S)
    m = sum(valid)
    assert 10 < m < 64 - 16
    assert valid == [True] * m + [False] * (64 - m)
    monkeypatch.setattr(tbl, "_fit_subtract", fit_subtract)
    for steps in (m, m + 16):
        got = tbl._blanker_fits_reference(*args, PW, steps, lead, S)
        assert all(torch.equal(a, b) for a, b in zip(got, full)), steps
    before = [x.clone() for x in args]
    tbl.blanker_fits(*args, PW, 64, lead, S)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_blanker_fits_vmap():
    """Three streams under torch.func.vmap (a fleet), each with its own
    threshold: the rule's result bit-equal to three separate calls."""
    weak, pwr, _ = _light_input("one-channel")
    streams = [(weak, pwr), (0.5 * weak, 0.25 * pwr),
               (weak[::-1].copy(), pwr[::-1].copy())]
    floors = torch.tensor([100.0, 30.0, 1e5])
    ws = torch.stack([_t(w) for w, _ in streams])
    ps = torch.stack([_t(p) for _, p in streams])
    tab = _t_tables()

    def one(w, p, f):
        return tbl.clever_blanker(w, p, tab, f, LIMIT_AMP, PW, 64)

    got = torch.func.vmap(one)(ws, ps, floors)
    for i in range(3):
        want = one(ws[i], ps[i], floors[i])
        assert all(torch.equal(a[i], b) for a, b in zip(got, want)), i
    assert len({int(n) for n in got[2]}) > 1


# ---- the kernel's candidate index, modelled in numpy -----------------

def _kernel_model(args: tuple, pw: int, max_pulses: int, lead: int, s: int,
                  w: int = 32):
    """numpy model of csrc/blanker_fits.cu's indexing around the plain
    version's fit arithmetic (``_fit`` on the staged rows).

    The kernel holds an active bit per sample, built from candp (set where
    candp is not negative), and the maxima of ``w``-sample sub-blocks and
    of groups of 32 sub-blocks; a sample's candidate power is its power
    where the bit is set, -1 elsewhere.  A fit picks the first maximal
    group, its first maximal sub-block, and stops if that maximum is at
    or under the threshold.  A NaN there is no fit: the plain version's
    refresh (``cand >= 0``) retires every NaN of the two blocks around it,
    and the loop goes on.  Else a fit stages the rows [lo, hi) of the whole
    sub-blocks around every window a sample of the sub-block can have,
    picks the sample from the staged rows, fits, writes the window back,
    retires +-pw around the sample and rebuilds the maxima of the
    sub-blocks the window touches and of their groups.  Asserts that all
    the fit reads or writes lies in the staged rows.  Returns (weak, pwr,
    nfit) as the plain version does, and the staged row counts."""
    wpad, ppad, candp, bmax, refbank, phasefunc, thr = args
    wk, pk = wpad.numpy().copy(), ppad.numpy().copy()
    cand = candp.numpy()
    total, pul = pk.shape[0], refbank.shape[1]
    nblk = bmax.shape[0]
    blk = total // nblk
    half = pul // 2
    tables = tbl.BlankerTables(refbank=refbank, phasefunc=phasefunc)
    act = ~(cand < 0)
    nsub = -(-total // w)
    value = lambda a, p: np.where(a, p, np.float32(-1))
    sub = np.array([np.max(value(act[g * w:(g + 1) * w],
                                 cand[g * w:(g + 1) * w]))
                    for g in range(nsub)], np.float32)
    top = np.array([np.max(sub[t * 32:(t + 1) * 32])
                    for t in range(-(-nsub // 32))], np.float32)
    nfit, staged = 0, []
    for _ in range(max_pulses):
        gi = int(np.argmax(top))          # NaN first, ties to the lowest
        if not (top[gi] > thr.item() or np.isnan(top[gi])):
            break
        si = gi * 32 + int(np.argmax(sub[gi * 32:(gi + 1) * 32]))
        s0, s1 = si * w, min(si * w + w, total)
        if np.isnan(top[gi]):
            p = s0 + int(np.argmax(value(act[s0:s1], pk[s0:s1])))
            b0 = int(np.clip((p - half - pw) // blk, 0, nblk - 2))
            r0, r1 = b0 * blk, b0 * blk + 2 * blk
            act[r0:r1] &= ~np.isnan(pk[r0:r1])
            for g in range(r0 // w, (r1 - 1) // w + 1):
                rows = slice(g * w, min(g * w + w, total))
                sub[g] = np.max(value(act[rows], pk[rows]))
            for t in range(r0 // w // 32, (r1 - 1) // w // 32 + 1):
                top[t] = np.max(sub[t * 32:(t + 1) * 32])
            continue
        wmin = int(np.clip(s0 - half, 0, total - pul))
        wmax = int(np.clip(s1 - 1 - half, 0, total - pul))
        lo, hi = wmin // w * w, min(((wmax + pul - 1) // w + 1) * w, total)
        staged.append(hi - lo)
        sw, sp, sa = wk[lo:hi].copy(), pk[lo:hi].copy(), act[lo:hi].copy()
        p = s0 + int(np.argmax(value(sa[s0 - lo:s1 - lo],
                                     sp[s0 - lo:s1 - lo])))
        start = int(np.clip(p - half, 0, total - pul))
        rlo, rhi = max(p - pw, 0), min(p + pw, total - 1)
        ga, gb = start // w, (start + pul - 1) // w
        assert lo <= min(start, rlo, ga * w), (lo, start, rlo)
        assert max(start + pul, rhi + 1, min((gb + 1) * w, total)) <= hi
        q = slice(start - lo, start - lo + pul)
        neww, newp, ok = tbl._fit(torch.from_numpy(sw[q]),
                                  torch.from_numpy(sp[q]), tables, pw,
                                  torch.tensor(True))
        if ok:
            sp[q] = newp.numpy()
            wk[start:start + pul], pk[start:start + pul] = neww.numpy(), sp[q]
        nfit += int(ok)
        sa[rlo - lo:rhi - lo + 1] = False
        act[rlo:rhi + 1] = False
        for g in range(ga, gb + 1):
            rows = slice(g * w - lo, min(g * w + w, total) - lo)
            sub[g] = np.max(value(sa[rows], sp[rows]))
        for t in range(ga // 32, gb // 32 + 1):
            top[t] = np.max(sub[t * 32:(t + 1) * 32])
    return (torch.from_numpy(wk[lead:lead + s]),
            torch.from_numpy(pk[lead:lead + s]),
            torch.tensor(nfit, dtype=torch.int32)), staged


@pytest.mark.parametrize("w", [32, 64])
@pytest.mark.parametrize("case", cs.FITS_EDGE_CASES)
def test_kernel_index_model(case, w):
    """The model of the kernel's indexing (bits, two-level maxima, staged
    rows, refresh) gives the plain version's bits on chip_smoke.py's
    crafted cases (the same arguments that phase 3b hands the kernel on
    the card), at the kernel's sub-block width 32 and at 64, the width it
    takes where its index would not fit: nfit exact, arrays equal.  At
    pulse 64 a fit stages 96 rows at W 32 and 192 at W 64, fewer where
    the window is clamped to the padded stream."""
    args = cs.fits_edge_args(case, CPU)
    _assert_fits_contract(*args)
    want = tbl._blanker_fits_reference(*args)
    got, staged = _kernel_model(args[:7], *args[7:], w)
    assert int(got[2]) == int(want[2]) >= 5
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert max(staged) == {32: 96, 64: 192}[w]
    if case == "padded-edges":
        assert min(staged) < max(staged)


@pytest.mark.parametrize("case", ["ties-blocks", "ties-sub-blocks", "nan",
                                  "inf"])
def test_small_cases_against_jax(case, fits_contract):
    """The plain version through _clever_blanker_blocked against JAX's on
    the tie, NaN and +inf cases: the same candidates in the same order
    (nfit exact), the NaN where it was, floats within FP32; the caller's
    arguments meet the operator's precondition.  A NaN at an
    active sample does not end the loop on either side: it wins the
    argmax, fits nothing, and the refresh (``cand >= 0``) retires it."""
    weak, pwr, _ = cs.fits_edge_case(case, BANK)
    j_tab = jbl.BlankerTables(refbank=jnp.asarray(BANK),
                              phasefunc=jnp.asarray(PHASEFUNC))
    jw, jp, jn = (np.asarray(v) for v in jbl._clever_blanker_blocked(
        jnp.asarray(weak), jnp.asarray(pwr), j_tab, jnp.asarray(NOISE_FLOOR),
        LIMIT_AMP, PW, cs.FITS_EDGE_FITS, cs.FITS_BLOCK))
    tw, tp, tn = tbl._clever_blanker_blocked(
        _t(weak), _t(pwr), _t_tables(), torch.tensor(NOISE_FLOOR),
        LIMIT_AMP, PW, cs.FITS_EDGE_FITS, cs.FITS_BLOCK)
    assert int(tn) == int(jn) >= 5 and len(fits_contract) == 1
    tp = tp.numpy()
    np.testing.assert_array_equal(np.isnan(tp), np.isnan(pwr))
    np.testing.assert_array_equal(np.isnan(jp), np.isnan(pwr))
    assert _rel(tw.numpy(), jw) <= FP32
    assert _rel(np.nan_to_num(tp), np.nan_to_num(jp)) <= FP32


# ---- sellim's taper --------------------------------------------------

def _geometries():
    """(name, JAX params) at fft1 2,048 (flagship), 8,192 (WCW) and
    16,384 (QRSS)."""
    return {"flagship": FLAGSHIP, "wcw": preset(RxMode.WCW),
            "qrss": preset(RxMode.QRSS)}


def _carrier_spectrum(rng, n, step, wide=True):
    """An averaged power spectrum with strong carriers of several widths
    (narrow ones and, when ``wide``, one of about a ninetieth of the band
    whose budget lasts every pass from fft1 8,192 on), weaker ones that
    sellim marks at unit gain, and noise."""
    k = np.arange(n)
    p = 1e3 * rng.chisquare(4, size=n) / 4
    carriers = [(n // 5 + step, 3e11, 1.5), (3 * n // 4, 5e9, 0.7)]
    if wide:
        carriers.append((n // 2 + n // 7, 1e12, n / 90))
    for centre, height, width in carriers:
        p += height * np.exp(-0.5 * ((k - centre) / width) ** 2)
    for centre in (n // 3 + 2 * step, n // 2 + 7, n - 9):
        p[centre % n] += 8e4 * (1 + step)
    return p.astype(np.float32)


def _jax_steps(params, spectra, maxlevel=8.0):
    """Successive updates through JAX's update_liminfo (jitted) over the
    spectra: (spectrum, sel_lo, sel_hi, liminfo, liminfo_wait) each."""
    geo = derive_geometry(params)
    n = geo.fft1_size
    upd = jax.jit(lambda s, p, lo, hi, geo=geo: jsellim.update_liminfo(
        geo, s, p, maxlevel, ston=30.0, sel_lo=lo, sel_hi=hi))
    st = jsellim.SellimState.create(geo)
    steps = []
    for p in spectra:
        lo, hi = n // 8, n // 8 + 6
        st = upd(st, jnp.asarray(p), jnp.int32(lo), jnp.int32(hi))
        steps.append((p, lo, hi, np.asarray(st.liminfo),
                      np.asarray(st.liminfo_wait)))
    return steps


@pytest.fixture(scope="module")
def taper_runs():
    """Three successive updates per geometry through JAX's update_liminfo
    (jitted), with the spectra fed."""
    runs = {}
    for name, params in _geometries().items():
        n = derive_geometry(params).fft1_size
        rng = np.random.default_rng(n)
        runs[name] = (params, _jax_steps(
            params, [_carrier_spectrum(rng, n, step) for step in range(3)]))
    return runs


def _t_update(params, steps, maxlevel=8.0, holds=None):
    """The port's update_liminfo over the same spectra; yields its states.
    Each (lim, budget) handed to sellim_taper goes through
    taper_closed_form_holds, whose answers go into ``holds`` where given
    (and the model of the kernel then gives the plain version's bits on
    it) and must be True where not."""
    tgeo = t_derive_geometry(convert.params_from_jax(params))
    st = tsellim.SellimState.create(tgeo, CPU)
    real = tsellim.sellim_taper
    seen = [] if holds is None else holds

    def checking(lim, budget):
        seen.append(tsellim.taper_closed_form_holds(lim, budget))
        assert holds is not None or seen[-1]
        out = real(lim, budget)
        if holds is not None:
            assert _same_bits(_taper_model(lim.numpy(), budget.numpy())[0],
                              out.numpy())
        return out

    for p, lo, hi, _jl, _jw in steps:
        tsellim.sellim_taper = checking
        try:
            st = tsellim.update_liminfo(tgeo, st, _t(p), maxlevel,
                                        ston=30.0, sel_lo=torch.tensor(lo),
                                        sel_hi=torch.tensor(hi))
        finally:
            tsellim.sellim_taper = real
        yield st


@pytest.mark.parametrize("name", ["flagship", "wcw", "qrss"])
def test_taper_through_update_liminfo(taper_runs, name):
    """update_liminfo through sellim_taper against JAX's: liminfo signs and
    liminfo_wait exact, gains within FP32, tapered skirts present."""
    params, steps = taper_runs[name]
    for st, (_p, _lo, _hi, jl, jw) in zip(_t_update(params, steps), steps):
        tl = st.liminfo.numpy()
        np.testing.assert_array_equal(np.sign(tl), np.sign(jl))
        np.testing.assert_array_equal(st.liminfo_wait.numpy(), jw)
        assert _rel(tl, jl) <= FP32
        assert (jl > 0).sum() > 20


def _broken_spectra(case: str, n: int) -> list:
    """Three spectra whose update breaks the closed form's precondition:
    a +inf power bin at a strong carrier's centre in the second (its
    segment's gain is 0, its budget not), or plain carriers for maxlevel
    0 (limit 0: every bin strong at gain 0)."""
    rng = np.random.default_rng(n + 3)
    spectra = [_carrier_spectrum(rng, n, step) for step in range(3)]
    if case == "inf":
        spectra[1][n // 5 + 1] = np.inf
    return spectra


@pytest.mark.parametrize("case", ["inf", "maxlevel-0"])
def test_taper_broken_precondition_update(case):
    """update_liminfo of the port against JAX's where the taper's inputs
    break the closed form's precondition (the kernel's window loop):
    liminfo signs and liminfo_wait exact, gains within FP32."""
    n = GEO.fft1_size
    maxlevel = 0.0 if case == "maxlevel-0" else 8.0
    steps = _jax_steps(FLAGSHIP, _broken_spectra(case, n), maxlevel)
    holds = []
    for st, (_p, _lo, _hi, jl, jw) in zip(
            _t_update(FLAGSHIP, steps, maxlevel, holds), steps):
        tl = st.liminfo.numpy()
        np.testing.assert_array_equal(np.sign(tl), np.sign(jl))
        np.testing.assert_array_equal(st.liminfo_wait.numpy(), jw)
        assert _rel(tl, jl) <= FP32
    assert holds == ([True, False, True] if case == "inf" else [False] * 3)


def _taper_inputs(params, steps):
    """The (lim, budget) each update hands sellim_taper."""
    seen = []
    real = tsellim.sellim_taper

    def recording(lim, budget):
        assert tsellim.taper_closed_form_holds(lim, budget)
        seen.append((lim.clone(), budget.clone()))
        return real(lim, budget)

    tsellim.sellim_taper = recording
    try:
        list(_t_update(params, steps))
    finally:
        tsellim.sellim_taper = real
    return seen


@pytest.mark.parametrize("name", ["flagship", "wcw", "qrss"])
def test_taper_stops_after_a_pass_without_change(name):
    """The kernel ends after the first pass that changes no bin: the plain
    version stopped there gives the same bits as all 64 passes (on
    carriers whose budgets run out before the 64th)."""
    params = _geometries()[name]
    n = derive_geometry(params).fft1_size
    rng = np.random.default_rng(n + 1)
    steps = [(_carrier_spectrum(rng, n, step, wide=False), n // 8,
              n // 8 + 6, None, None) for step in range(3)]
    for lim, budget in _taper_inputs(params, steps):
        full = tsellim._sellim_taper_reference(lim, budget)
        prev, left = lim, budget
        for k in range(1, tsellim.TAPER_STEPS + 1):
            cur, left = tsellim._taper_pass(prev, left)
            if torch.equal(cur, prev):
                break
            prev = cur
        assert 1 < k < tsellim.TAPER_STEPS, k
        assert torch.equal(prev, full)
        assert torch.equal(tsellim.sellim_taper(lim, budget), full)


def test_taper_vmap(taper_runs):
    """Three streams under torch.func.vmap, and a budget shared by all:
    bit-equal to separate calls."""
    params, steps = taper_runs["flagship"]
    (l0, b0), (l1, b1), (l2, b2) = _taper_inputs(params, steps)
    lims = torch.stack([l0, l1, l2])
    budgets = torch.stack([b0, b1, b2])
    got = torch.func.vmap(tsellim.sellim_taper)(lims, budgets)
    shared = torch.func.vmap(tsellim.sellim_taper,
                             in_dims=(0, None))(lims, b0)
    for i in range(3):
        assert torch.equal(got[i], tsellim.sellim_taper(lims[i],
                                                        budgets[i]))
        assert torch.equal(shared[i], tsellim.sellim_taper(lims[i], b0))
    assert not torch.equal(got[0], got[1])


# ---- a numpy model of the taper kernel ---------------------------------
#
# csrc/sellim_taper.cu computes tiles of TAPER_TILE bins, each from a
# window of SLOTS slots (the tile and 64 bins on each side, zero past the
# band's ends): in closed form where every weak bin of the window has
# budget < 1, else by the passes over the window's real bins.  The model
# follows the kernel slot by slot (the nearest nonzero slots, each source's
# two chains and how far they run, the selection, the window loop) and is
# held bit for bit to the plain version.  Change both together.

TILE, HALO = tsellim.TAPER_TILE, tsellim.TAPER_STEPS
SLOTS = TILE + 2 * HALO
NEVER = 1 << 30


def _pow09(x: np.ndarray) -> np.ndarray:
    """float32 x ** 0.9 as the plain version's passes compute it here:
    torch's vectorized pow on the CPU (the elements past the last whole
    vector of a call take a scalar routine whose bits differ, so x is
    padded to a multiple of 64; the cases keep n a multiple of 64 for the
    same reason)."""
    m = len(x)
    t = torch.from_numpy(np.concatenate([x, np.ones(-m % 64, np.float32)]))
    return (t ** 0.9).numpy()[:m]


def _model_pass(lim: np.ndarray, budget: np.ndarray):
    """One pass of the taper, edge-replicated (the JAX taper_body)."""
    sh_r = lambda x: np.concatenate([x[:1], x[:-1]])
    sh_l = lambda x: np.concatenate([x[1:], x[-1:]])
    bl, br = sh_r(budget), sh_l(budget)
    cand = np.maximum(np.where(bl >= 1, sh_r(lim), np.float32(0)),
                      np.where(br >= 1, sh_l(lim), np.float32(0)))
    new = (lim == 0) & (cand > 0)
    return (np.where(new, _pow09(cand), lim),
            np.where(new, np.maximum(bl - 1, br - 1), budget))


def _model_closed_form(L: np.ndarray, B: np.ndarray,
                       core_end: int) -> np.ndarray:
    """The kernel's closed form over one window's slots."""
    j = np.arange(SLOTS)
    nz = L != 0
    left = np.maximum.accumulate(np.where(nz, j, -1))
    left = np.concatenate([[-1], left[:-1]])          # nearest set < j
    right = np.minimum.accumulate(np.where(nz, j, NEVER)[::-1])[::-1]
    right = np.concatenate([right[1:], [NEVER]])      # nearest set > j
    dl = np.where((left >= 0) & (j - left <= HALO), j - left, 0)
    dr = np.where((right < NEVER) & (right - j <= HALO), right - j, 0)
    cl, cr = L.copy(), L.copy()
    src = np.nonzero((L > 0) & (B >= 1))[0]
    by_budget = np.where(B[src] >= HALO, HALO,
                         np.floor(np.minimum(B[src], HALO))).astype(int)

    def reach(gap):
        return np.where(gap > 0, np.minimum(by_budget, gap - 1), by_budget)

    kr = np.where(src + 1 < core_end,
                  np.minimum(reach(dr[src]), core_end - 1 - src), 0)
    kl = np.where(src - 1 >= HALO, np.minimum(reach(dl[src]), src - HALO), 0)
    chain = L[src]                  # both fronts of a source carry it
    for k in range(1, HALO + 1):
        chain = _pow09(chain)
        cl[src[k <= kr] + k] = chain[k <= kr]
        cr[src[k <= kl] - k] = chain[k <= kl]
    out = L.copy()
    jj = np.nonzero((j >= HALO) & (j < core_end) & (L == 0))[0]
    d_l, d_r = dl[jj], dr[jj]
    gl, bl = L[jj - d_l], B[jj - d_l]
    gr, br = L[jj + d_r], B[jj + d_r]
    tl = np.where((d_l > 0) & (gl > 0) & (bl >= d_l), d_l, NEVER)
    tr = np.where((d_r > 0) & (gr > 0) & (br >= d_r), d_r, NEVER)
    dark = ((d_l == 1) & np.isnan(gl) & (bl >= 1)) \
        | ((d_r == 1) & np.isnan(gr) & (br >= 1))
    tie = _pow09(np.maximum(cl[jj - 1], cr[jj + 1]))
    val = np.where(tl < tr, cl[jj], np.where(tr < tl, cr[jj], tie))
    lit = ~dark & ((tl < NEVER) | (tr < NEVER))
    out[jj] = np.where(lit, val, L[jj])
    return out


def _taper_model(lim: np.ndarray, budget: np.ndarray):
    """The kernel on one stream: (the new lim, per tile 1 where it ran the
    window loop)."""
    n = len(lim)
    out, paths = lim.copy(), []
    for t0 in range(0, n, TILE):
        lo, hi = max(0, HALO - t0), min(SLOTS, n - t0 + HALO)
        core_end = min(HALO + TILE, hi)
        L = np.zeros(SLOTS, np.float32)
        B = np.zeros(SLOTS, np.float32)
        L[lo:hi] = lim[t0 - HALO + lo:t0 - HALO + hi]
        B[lo:hi] = budget[t0 - HALO + lo:t0 - HALO + hi]
        looped = bool(np.any((L[lo:hi] == 0) & ~(B[lo:hi] < 1)))
        paths.append(int(looped))
        if looped:
            wl, wb = L[lo:hi], B[lo:hi]
            for _ in range(HALO):
                new, wb = _model_pass(wl, wb)
                if np.array_equal(new.view(np.int32), wl.view(np.int32)):
                    break
                wl = new
            L[lo:hi] = wl
        else:
            L = _model_closed_form(L, B, core_end)
        out[t0:t0 + core_end - HALO] = L[HALO:core_end]
    return out, paths


def _same_bits(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("name", cs.TAPER_EDGE_CASES)
def test_taper_model_edge_cases(name):
    """The model of the kernel, bit for bit against the plain version on
    chip_smoke.py's crafted cases (the arguments phase 3b hands the card),
    with the tiles' paths as the precondition gives them; the vmap case
    also through the operator's vmap rule, with its own budgets and with
    one shared."""
    lim, budget = cs.taper_edge_args(name, CPU)
    lims = lim.reshape(-1, lim.shape[-1])
    buds = budget.reshape(-1, budget.shape[-1])
    paths = []
    for l, b in zip(lims, buds):
        want = tsellim._sellim_taper_reference(l, b).numpy()
        got, p = _taper_model(l.numpy(), b.numpy())
        assert _same_bits(got, want), np.nonzero(
            got.view(np.int32) != want.view(np.int32))
        paths.append(p)
    assert paths == cs.taper_expected_paths(lim, budget, TILE)
    looped = sum(map(sum, paths))
    if name in ("gain-zero", "weak-budget", "vmap"):
        assert looped >= 1
    else:
        assert looped == 0 and tsellim.taper_closed_form_holds(lim, budget)
    if name == "vmap":
        got = torch.func.vmap(tsellim.sellim_taper)(lim, budget)
        shared = torch.func.vmap(tsellim.sellim_taper,
                                 in_dims=(0, None))(lim, budget[0])
        for i in range(len(lim)):
            assert _same_bits(got[i], _taper_model(lim[i].numpy(),
                                                   budget[i].numpy())[0])
            assert _same_bits(shared[i], _taper_model(
                lim[i].numpy(), budget[0].numpy())[0])


def _random_taper_case(rng) -> tuple[np.ndarray, np.ndarray]:
    """Segments of widths 1-40 with gaps of 0-200 bins; gains mostly in
    (0, 1], sometimes NaN, 0, +inf, negative or above 1; weak bins now and
    then with budget >= 1 or a fractional budget under 1."""
    n = int(rng.choice([512, 1024, 2048, 2944]))
    lim = np.zeros(n, np.float32)
    bud = np.zeros(n, np.float32)
    pos = int(rng.integers(0, 60))
    while pos < n:
        width = int(rng.integers(1, 41))
        u = rng.random()
        gain = (np.nan if u < 0.04 else 0.0 if u < 0.07 else np.inf
                if u < 0.09 else -1.0 if u < 0.12 else 2.5 if u < 0.15
                else rng.uniform(1e-3, 1.0))
        lim[pos:pos + width] = gain
        bud[pos:pos + width] = width / 4 + 1 if rng.random() < 0.9 \
            else rng.uniform(0, 120)
        pos += width + int(rng.integers(0, 201))
    weak = np.nonzero(lim == 0)[0]
    if rng.random() < 0.2:
        hit = rng.choice(weak, size=3)
        bud[hit] = rng.choice([1.0, 2.5, 70.0], size=3)
    if rng.random() < 0.3:
        hit = rng.choice(weak, size=5)
        bud[hit] = rng.uniform(0, 1, 5)
    return lim, bud


@pytest.mark.parametrize("seed", range(4))
def test_taper_model_random(seed):
    """The model against the plain version, bit for bit, on 40 random
    cases per seed; across the seeds both paths are taken."""
    rng = np.random.default_rng(1000 + seed)
    looped = closed = 0
    for _ in range(40):
        lim, bud = _random_taper_case(rng)
        want = tsellim._sellim_taper_reference(_t(lim), _t(bud)).numpy()
        got, paths = _taper_model(lim, bud)
        assert _same_bits(got, want)
        looped += sum(paths)
        closed += len(paths) - sum(paths)
    assert looped and closed


# ---- what the wrappers refuse ----------------------------------------

def _taper_ok():
    return torch.zeros(64), torch.zeros(64)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "empty"])
def test_taper_refuses(bad):
    lim, budget = _taper_ok()
    if bad == "dtype":
        lim = lim.double()
    elif bad == "shape":
        budget = budget[:-1]
    elif bad == "device":
        budget = budget.to("meta")
    else:
        lim, budget = lim[:0], budget[:0]
    with pytest.raises(ValueError, match="sellim_taper"):
        tsellim.sellim_taper(lim, budget)


@pytest.mark.parametrize("bad", ["wpad dtype", "ppad shape", "bmax",
                                 "thr", "tables", "device", "width",
                                 "rows"])
def test_blanker_fits_refuses(bad):
    weak = np.zeros((S, 1), np.complex64)
    (wpad, ppad, candp, bmax, bank, pf, thr), lead = _fits_args(
        weak, np.zeros(S, np.float32))
    pw, s = PW, S
    if bad == "wpad dtype":
        wpad = wpad.to(torch.complex128)
    elif bad == "ppad shape":
        ppad = ppad[1:]
    elif bad == "bmax":
        bmax = bmax.reshape(1, -1)
    elif bad == "thr":
        thr = thr.reshape(1)
    elif bad == "tables":
        pf = pf[1:]
    elif bad == "device":
        thr = thr.to("meta")
    elif bad == "width":
        pw = 32
    else:
        s = wpad.shape[0]
    with pytest.raises(ValueError, match="blanker_fits"):
        tbl.blanker_fits(wpad, ppad, candp, bmax, bank, pf, thr, pw, 64,
                         lead, s)


@pytest.mark.parametrize("bad", ["weak dtype", "no channels", "pwr shape",
                                 "floor shape", "width", "negative width",
                                 "device", "empty", "too long"])
def test_blanker_clear_refuses(bad):
    weak, pwr, nf, limit, pw = cs.clear_edge_args("tile-edges", CPU)
    if bad == "weak dtype":
        weak = weak.to(torch.complex128)
    elif bad == "no channels":
        weak = weak[:, :0]
    elif bad == "pwr shape":
        pwr = pwr[1:]
    elif bad == "floor shape":
        nf = nf.reshape(1)
    elif bad == "width":
        pw = tbl.CLEAR_MAX_PW + 1
    elif bad == "negative width":
        pw = -1
    elif bad == "device":
        nf = nf.to("meta")
    elif bad == "empty":
        weak, pwr = weak[:0], pwr[:0]
    else:
        weak = torch.empty((tbl.CLEAR_MAX_S, 1), dtype=torch.complex64,
                           device="meta")
        pwr = torch.empty(tbl.CLEAR_MAX_S, device="meta")
        nf = nf.to("meta")
    with pytest.raises(ValueError, match="blanker_clear"):
        tbl.blanker_clear(weak, pwr, nf, limit, pw)


@pytest.mark.parametrize("name", cuda_build.KERNELS)
def test_op_schema_and_fake(name):
    """Each hand kernel's custom operator passes torch.library.opcheck's
    schema and fake-tensor checks (the fake gives the shapes a trace sees,
    and refuses what the operator refuses); on the CPU no kernel launch is
    counted."""
    if name == "blanker_fits":
        weak, pwr, _ = _light_input("two-channel")
        args, lead = _fits_args(weak, pwr)
        op, args = tbl.blanker_fits, (*args, PW, 4, lead, S)
    elif name == "blanker_clear":
        op, args = tbl.blanker_clear, cs.clear_edge_args("long-run", CPU)
    elif name == "fused_fft1":
        rng = np.random.default_rng(5)
        frames = rng.normal(size=(16, 512, 2)) \
            + 1j * rng.normal(size=(16, 512, 2))
        op, args = tff._fused_fft1_op, (
            _t(frames.astype(np.complex64)),
            _t(np.hanning(512).astype(np.float32)),
            _t(np.ones((512, 2), np.complex64)))
    elif name == "radar_stats":
        op, args = trd._frame_pulse_stats_op, (
            _t(cs.stats_case("spike", 16, 2048)), 32)
    elif name == "sellim_update":
        op, args = tsellim.sellim_update, cs.update_edge_args("history", CPU)
    elif name == "mix1_ramp":
        op, args = tmix1.mix1_ramp, cs.ramp_args((4096, 1, True, True), CPU)
    else:
        n = GEO.fft1_size
        spectrum = _carrier_spectrum(np.random.default_rng(n + 2), n, 0)
        (lim, budget), = _taper_inputs(
            FLAGSHIP, [(spectrum, n // 8, n // 8 + 6, None, None)])
        op, args = tsellim.sellim_taper, (lim, budget)
    count = cuda_build.COUNTS[name]
    before = (count.launches, count.captured)
    checks = ("test_schema", "test_faketensor")
    assert torch.library.opcheck(op, args, test_utils=checks) == dict.fromkeys(
        checks, "SUCCESS")
    assert (count.launches, count.captured) == before


def test_build_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc to be found, building a kernel raises and names it;
    build_all raises once every build has ended."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    cuda_build.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="sellim_taper: nvcc not found"):
            cuda_build.build("sellim_taper")
        with pytest.raises(RuntimeError,
                           match="blanker_clear: nvcc not found"):
            cuda_build.build("blanker_clear")
        assert "blanker_clear" in cuda_build.KERNELS
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.build_all()
    finally:
        cuda_build.build.cache_clear()
