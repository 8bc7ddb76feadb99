"""The port's round-parallel clever blanker (clever_blanker(rounds=r),
linrad_tpu_torch/ops/blanker.py) against the JAX package's, and against
the port's own sequential variants, mirroring tests/test_wideband.py's
TestBlankers; then both blankers under torch.func.vmap, as the fleet runs
them.

Bars: fitted counts exact; weak' and pwr' within 1e-5 (max_rel) of JAX's
(the same fp32 formulas, reduced in another order); where the fit
windows are disjoint the parallel variant equals the sequential scan
bit for bit (the subtractions commute); on interacting pulses within
1 dB of it and no more than one pulse fewer, as the JAX test holds its
own.  Under vmap every stream equals the same call on that stream alone,
bit for bit, and no operation may take vmap's slow path (its warning is
an error here).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linrad_tpu import RxParams as JRxParams
from linrad_tpu import derive_geometry
from linrad_tpu.ops import blanker as jbl
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import blanker as tbl

# the start of the warning vmap gives where an operation has no batching
# rule and it loops over the batch instead
SLOW_PATH = "There is a performance drop"


def _tables(**kw):
    """Both packages' blanker tables and pulse width at fft1 512."""
    jp = JRxParams(second_fft_enable=True, fft1_n_override=9, **kw)
    j_tab, pw = jbl.BlankerTables.create(derive_geometry(jp))
    t_tab, t_pw = tbl.BlankerTables.create(
        t_derive_geometry(convert.params_from_jax(jp)), "cpu")
    assert t_pw == pw
    return j_tab, t_tab, pw


def _pulse(rng, length, frac, amp):
    k = np.fft.fftfreq(length) * length
    p = np.roll(np.fft.ifft(np.exp(-2j * np.pi * k * frac / length)),
                length // 2)
    return amp * np.exp(1j * rng.uniform(0, 2 * np.pi)) * p


def _stream(seed, s, channels, sites):
    """Complex noise of 0.1 and 64-sample pulses at (pos, frac, amp)."""
    rng = np.random.default_rng(seed)
    weak = ((rng.normal(size=(s, channels))
             + 1j * rng.normal(size=(s, channels))) * 0.1
            ).astype(np.complex64)
    for pos, frac, amp in sites:
        pul = _pulse(rng, 64, frac, amp)
        lo, hi = max(0, pos - 32), min(s, pos + 32)
        weak[lo:hi, 0] += pul[lo - (pos - 32): 64 - (pos + 32 - hi)
                              ].astype(np.complex64)
    pwr = np.sum(np.abs(weak) ** 2, 1).astype(np.float32)
    return weak, pwr


# every pair >= pul + 2 pw apart: disjoint fit windows (test_wideband.py)
DISJOINT = [(60, 0.1, 25.0), (300, -0.2, 18.0), (500, 0.4, 30.0),
            (900, 0.0, 22.0), (1500, 0.25, 12.0), (2980, -0.1, 40.0)]
# a cluster around the block-256 boundary and an interacting pair
DENSE = [(230, 0.1, 25.0), (255, -0.3, 35.0), (280, 0.2, 20.0),
         (1020, 0.0, 30.0), (1045, 0.4, 28.0)]

CASES = {
    "disjoint-2ch": dict(seed=11, s=3000, channels=2, sites=DISJOINT,
                         rounds=6, nf=0.04),
    "dense": dict(seed=5, s=2048, channels=1, sites=DENSE, rounds=8,
                  nf=0.04),
    "few-rounds": dict(seed=5, s=2048, channels=1, sites=DENSE + DISJOINT,
                       rounds=2, nf=0.04),
    "eligible": dict(seed=7, s=3000, channels=2, sites=DENSE + [
        (1700, 0.3, 30.0), (2200, -0.4, 26.0)], rounds=8, nf=0.04,
        eligible=0.8),
    "block-512": dict(seed=3, s=4100, channels=1, sites=DENSE + DISJOINT,
                      rounds=4, nf=0.04, block=512),
}


def _case(name):
    c = CASES[name]
    weak, pwr = _stream(c["seed"], c["s"], c["channels"], c["sites"])
    elig = None
    if "eligible" in c:
        elig = np.random.default_rng(c["seed"]).random(c["s"]) < c["eligible"]
    return c, weak, pwr, elig


@pytest.mark.parametrize("name", list(CASES))
def test_parallel_against_jax(name):
    c, weak, pwr, elig = _case(name)
    j_tab, t_tab, pw = _tables(rx_rf_channels=c["channels"])
    blk = c.get("block", 256)
    jw, jp, jn = jax.jit(lambda w, p, e: jbl.clever_blanker(
        w, p, j_tab, jnp.float32(c["nf"]), 6.0, pw, 16, block_size=blk,
        rounds=c["rounds"], eligible=e))(
            jnp.asarray(weak), jnp.asarray(pwr),
            None if elig is None else jnp.asarray(elig))
    tw, tp, tn = tbl.clever_blanker(
        torch.from_numpy(weak), torch.from_numpy(pwr), t_tab,
        torch.tensor(c["nf"]), 6.0, pw, 16, block_size=blk,
        rounds=c["rounds"],
        eligible=None if elig is None else torch.from_numpy(elig))
    assert tn.dtype == torch.int32
    assert int(tn) == int(jn) > 0
    for a, b in ((tw.numpy(), np.asarray(jw)), (tp.numpy(), np.asarray(jp))):
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-5


def test_parallel_matches_flat_scan():
    """Disjoint fit windows: rounds=6 equals the flat scan bit for bit,
    pulses inside one block included."""
    c, weak, pwr, _ = _case("disjoint-2ch")
    _j, t_tab, pw = _tables(rx_rf_channels=2)
    args = (torch.from_numpy(weak), torch.from_numpy(pwr), t_tab,
            torch.tensor(0.04), 6.0, pw, 16)
    wf, pf, nf = tbl.clever_blanker(*args, block_size=0)
    wp, pp, np_ = tbl.clever_blanker(*args, rounds=6)
    assert int(nf) == int(np_) == len(DISJOINT)
    assert torch.equal(wf, wp) and torch.equal(pf, pp)


def test_parallel_dense_cluster_suppression():
    """Interacting pulses may be fitted in another order than the
    strongest-first scan; the residual power stays within 1 dB of it."""
    _c, weak, pwr, _ = _case("dense")
    _j, t_tab, pw = _tables()
    args = (torch.from_numpy(weak), torch.from_numpy(pwr), t_tab,
            torch.tensor(0.04), 6.0, pw, 16)
    _, pf, nf = tbl.clever_blanker(*args, block_size=0)
    _, pp, np_ = tbl.clever_blanker(*args, rounds=8)
    assert int(np_) >= int(nf) - 1
    assert abs(10 * np.log10(float(pp.sum()) / float(pf.sum()))) < 1.0


def test_eligible_restricts_centres():
    """No eligible centre: nothing is fitted and nothing changes; the
    sequential variants take no eligible mask."""
    _c, weak, pwr, _ = _case("dense")
    _j, t_tab, pw = _tables()
    w, p = torch.from_numpy(weak), torch.from_numpy(pwr)
    none = torch.zeros(w.shape[0], dtype=torch.bool)
    w2, p2, n = tbl.clever_blanker(w, p, t_tab, torch.tensor(0.04), 6.0, pw,
                                   16, rounds=8, eligible=none)
    assert int(n) == 0 and torch.equal(w2, w) and torch.equal(p2, p)
    with pytest.raises(ValueError, match="rounds"):
        tbl.clever_blanker(w, p, t_tab, torch.tensor(0.04), 6.0, pw, 16,
                           eligible=none)


@pytest.mark.parametrize("rounds", [0, 8])
def test_blankers_under_vmap(rounds):
    """Three streams through one vmapped call equal three calls, bit for
    bit, with no operation on vmap's slow path: the sequential fit loop
    (rounds=0, the fleet's main path) and the round-parallel one."""
    _j, t_tab, pw = _tables()
    streams = [_stream(seed, 2048, 1, DENSE[seed:] + DISJOINT[:4])
               for seed in range(3)]
    weak = torch.from_numpy(np.stack([w for w, _ in streams]))
    pwr = torch.from_numpy(np.stack([p for _, p in streams]))
    nf = torch.tensor([0.04, 0.05, 0.03])

    def one(w, p, f):
        return tbl.clever_blanker(w, p, t_tab, f, 6.0, pw, 16,
                                  rounds=rounds)

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=SLOW_PATH)
        vw, vp, vn = torch.func.vmap(one)(weak, pwr, nf)
    for r in range(3):
        w, p, n = one(weak[r], pwr[r], nf[r])
        assert int(vn[r]) == int(n) > 0
        assert torch.equal(vw[r], w) and torch.equal(vp[r], p)
