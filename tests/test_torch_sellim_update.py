"""Sellim's liminfo update as the port runs it on the card: one custom
operator, ``ops/sellim.py:sellim_update`` (``update_liminfo`` with the
geometry's constants), on a CUDA tensor the front and back kernels of
``csrc/sellim_update.cu`` around the taper's, on a CPU tensor its plain
version ``_update_liminfo_reference`` (the former ``update_liminfo``, its
operations unchanged).

On the CPU these tests hold:

- a numpy model of the two kernels (each thread's chunk of
  ceil(n / 1,024) band bins, the skirt chains as max-scans of 2 j + 1 and
  2 j, the segmented scans of the strong runs in both directions, the
  chunks' aggregates and the scans across threads, the gains; the floor's
  three smallest a group and its sums in the order of PyTorch's CUDA
  reduction; the SFAC growth as 9-bit windows, the counters, the release
  cap, the band's edges and the passband), bit for bit against the plain
  version on ``chip_smoke.py``'s crafted cases (the arguments phase 3b
  hands the card), on random spectra and states, on successive updates
  whose counters count down, and on two channels' power: liminfo,
  liminfo_wait and the taper's arguments; the carrier threshold within a
  few float32 roundings of the CPU's (which divides where the card's mean
  multiplies, and sums in its own order);
- the vmap rule (per stream on the CPU) bit-equal to separate calls, a
  passband per stream and one shared;
- what the operator and the card's wrapper refuse.

The tests marked ``card`` need a CUDA device (they skip here): the kernels
bit for bit against the plain version on the card (and the threshold
equal to the plain version's), on the arguments of eager flagship and EME
steps and on every crafted case; one launch of each kernel under vmap over
8 streams and per graph replay; the wrapper's refusals there.  This file
imports no JAX and needs nothing of ``tests/conftest.py``, so that on the
machine with the card ``python -m pytest --noconftest
tests/test_torch_sellim_update.py -m card`` runs them.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from linrad_tpu_torch.ops import sellim as sl

CPU = "cpu"
F32 = np.float32
THREADS = 1024          # the front kernel's block: a thread a chunk
REACH = 4               # the SFAC rounds


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---- the numpy model of the two kernels --------------------------------

def _scan_excl(values: list, ident, op, reverse: bool) -> list:
    """The exclusive scan of the threads' aggregates, from the first
    thread (or, reversed, from the last)."""
    order = range(len(values) - 1, -1, -1) if reverse else range(len(values))
    out, acc = [None] * len(values), ident
    for t in order:
        out[t] = acc
        acc = op(acc, values[t])
    return out


def _seg_op(none: int):
    """A then b along the scan: b's reset wins, else both spans."""
    def op(a, b):
        if b[0] != none:
            return b
        return (a[0], max(a[1], b[1]), min(a[2], b[2]))
    return op


def _floor_model(p: np.ndarray, ston, groups: int) -> F32:
    """Step 5 as the front kernel takes it: each group's three smallest
    (a NaN after every number), their mean (x0 + x2) + x1 times the float
    of 1/3, the groups' mean, the selected groups' sum over their count,
    times ston."""
    n = len(p)
    m = n // groups
    third = F32(groups) / F32(3 * groups)
    gm = []
    for g in range(groups):
        x0, x1, x2 = np.sort(p[g * m:(g + 1) * m])[:3]
        gm.append(F32(F32(F32(x0 + x2) + x1) * third))
    gm = np.array(gm, F32)
    gavg = F32(cs.cuda_row_sum(gm) * (F32(1) / F32(groups)))
    sel = gm < F32(2) * gavg
    total = cs.cuda_row_sum(np.where(sel, gm, F32(0)))
    return F32(F32(total / F32(max(int(sel.sum()), 1))) * F32(ston))


def _front_model(p: np.ndarray, oldpos: np.ndarray, limit: F32):
    """The front kernel on band-ordered power and old positive gains:
    (lim, budget) for the taper, band order."""
    n = len(p)
    k = -(-n // THREADS)
    chunks = [(min(t * k, n), min(t * k + k, n)) for t in range(THREADS)]
    j = np.arange(n)
    pl, pr = p[np.maximum(j - 1, 0)], p[np.minimum(j + 1, n - 1)]
    strong0 = p > limit
    kf = np.where(strong0, 2 * j + 1, np.where(~(p < F32(0.3) * pl),
                                               2 * j, -1)).tolist()
    back = 2 * (n - 1 - j)
    kb = np.where(strong0, back + 1, np.where(~(p < F32(0.3) * pr),
                                              back, -1)).tolist()
    # the chains: chunk maxima, the scans across threads, the walks
    pf = _scan_excl([max(kf[a:b], default=-1) for a, b in chunks], -1, max,
                    False)
    pb = _scan_excl([max(kb[a:b], default=-1) for a, b in chunks], -1, max,
                    True)
    strong = [False] * n
    for (a, b), run_f, run_b in zip(chunks, pf, pb):
        for x in range(a, b):
            run_f = max(run_f, kf[x])
            strong[x] = run_f >= 0 and run_f % 2 == 1
        for x in range(b - 1, a - 1, -1):
            run_b = max(run_b, kb[x])
            strong[x] = strong[x] or (run_b >= 0 and run_b % 2 == 1)
    # the segments: each chunk's two aggregates, walking down it
    inf = float("inf")
    aggs_f, aggs_b = [], []
    pv, ov = p.tolist(), oldpos.tolist()
    for a, b in chunks:
        sf, sb, seen = (-1, -inf, inf), (n, -inf, inf), False
        for x in range(b - 1, a - 1, -1):
            if strong[x]:
                if not seen:
                    sf = (sf[0], max(sf[1], pv[x]), min(sf[2], ov[x]))
                sb = (sb[0], max(sb[1], pv[x]), min(sb[2], ov[x]))
            else:
                if not seen:
                    sf = (x, sf[1], sf[2])
                seen = True
                sb = (x, -inf, inf)
        aggs_f.append(sf)
        aggs_b.append(sb)
    pre_f = _scan_excl(aggs_f, (-1, -inf, inf), _seg_op(-1), False)
    pre_b = _scan_excl(aggs_b, (n, -inf, inf), _seg_op(n), True)
    maxval = np.zeros(n, F32)
    oldmin = np.zeros(n, F32)
    width = np.zeros(n, F32)
    for (a, b), sf, sb in zip(chunks, pre_f, pre_b):
        start = {}
        for x in range(a, b):
            if strong[x]:
                sf = (sf[0], max(sf[1], pv[x]), min(sf[2], ov[x]))
                maxval[x], oldmin[x], start[x] = sf[1], sf[2], sf[0] + 1
            else:
                sf = (x, -inf, inf)
        for x in range(b - 1, a - 1, -1):
            if strong[x]:
                sb = (sb[0], max(sb[1], pv[x]), min(sb[2], ov[x]))
                maxval[x] = max(maxval[x], sb[1])
                oldmin[x] = min(oldmin[x], sb[2])
                width[x] = sb[0] - start[x]
            else:
                sb = (x, -inf, inf)
    strong = np.array(strong)
    with np.errstate(all="ignore"):
        gain = np.sqrt(limit / np.where(maxval < limit, limit, maxval))
        ratio = oldmin / np.where(gain < F32(1e-20), F32(1e-20), gain)
        smooth = (ratio > F32(0.1)) & (ratio < F32(10)) & np.isfinite(oldmin)
        gain = np.where(smooth, oldmin * F32(0.8) + gain * F32(0.2), gain)
    lim = np.where(strong, gain, F32(0)).astype(F32)
    budget = np.where(strong, width * F32(0.25) + F32(1), F32(0))
    return lim, budget.astype(F32)


def _back_model(p, tapered, thr, old, oldw, half, wait_n):
    """The back kernel: the SFAC growth over 9-bit windows (bit w: bin
    j - 4 + w; past the band's ends power NaN and gain 1), then the
    counters, the release cap and the band's edges; band order."""
    n = len(p)
    j = np.arange(n)
    weak = car = from_l = from_r = np.zeros(n, np.int64)
    pad_p = np.concatenate([np.full(REACH + 1, np.nan, F32), p,
                            np.full(REACH + 1, np.nan, F32)])
    pad_l = np.concatenate([np.ones(REACH + 1, F32), tapered,
                            np.ones(REACH + 1, F32)])
    with np.errstate(invalid="ignore"):
        for w in range(2 * REACH + 1):
            at = j + w + 1          # pad index of bin j - 4 + w
            z = pad_l[at] == 0
            weak = weak | (z.astype(np.int64) << w)
            car = car | ((z & (pad_p[at] > thr)).astype(np.int64) << w)
            if 0 < w < 2 * REACH:
                twice = F32(2) * pad_p[at]
                from_l = from_l | ((twice < pad_p[at - 1]).astype(np.int64)
                                   << w)
                from_r = from_r | ((twice < pad_p[at + 1]).astype(np.int64)
                                   << w)
    for _ in range(REACH):
        car = car | ((((car << 1) & from_l) | ((car >> 1) & from_r)) & weak)
    lim = np.where((car >> REACH) & 1 == 1, F32(-1), tapered).astype(F32)
    strong = lim != 0
    wait = np.where(strong, wait_n, np.maximum(oldw - 1, 0)).astype(np.int32)
    lim = np.where(~strong & (wait > 0), F32(-1), lim)
    cap = np.where(old > 0, old * F32(1.15), F32(np.inf))
    lim = np.where((lim > 0) & (lim > cap) & (cap < 1), cap, lim)
    lim = np.where((j < 2) | (j >= n - 2), F32(0), lim).astype(F32)
    return lim, wait


def _update_model(args: tuple) -> dict:
    """sellim_update's two kernels on one stream's CPU arguments, the
    taper between them its plain version: liminfo, liminfo_wait (DC-at-0
    order), the taper's (lim, budget) and the threshold."""
    avg, old, oldw, lo, hi, limit, ston, half, wait_n, groups = args
    avg, old, oldw = avg.numpy(), old.numpy(), oldw.numpy()
    p = np.roll(np.where(avg < F32(1e-30), F32(1e-30), avg), half)
    oldb = np.roll(old, half)
    oldpos = np.where(oldb > 0, oldb, F32(np.inf)).astype(F32)
    lim0, budget = _front_model(p.astype(F32), oldpos, F32(limit))
    thr = _floor_model(p.astype(F32), ston, groups)
    tapered = sl._sellim_taper_reference(torch.from_numpy(lim0),
                                         torch.from_numpy(budget)).numpy()
    lim, wait = _back_model(p.astype(F32), tapered, thr, oldb,
                            np.roll(oldw, half), half, wait_n)
    lim, wait = np.roll(lim, -half), np.roll(wait, -half)
    if lo is not None:
        i = np.arange(len(lim))
        in_sel = (i >= int(lo)) & (i <= int(hi))
        lim = np.where(in_sel, F32(0), lim)
        wait = np.where(in_sel, 0, wait).astype(np.int32)
    return {"lim": lim, "wait": wait, "lim0": lim0, "budget": budget,
            "thr": thr}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def _plain(args: tuple) -> tuple:
    """The plain version on the CPU: (liminfo, liminfo_wait), the taper's
    arguments, the threshold by the same operations."""
    out = []
    (taper,) = cs.record_calls(sl, "sellim_taper", lambda: out.append(
        sl._update_liminfo_reference(*args)))
    return out[0], taper, cs.card_floor_thr(args)


def _assert_model(args: tuple) -> dict:
    """The model against the plain version on the CPU: liminfo,
    liminfo_wait and the taper's arguments bit for bit, the threshold
    within a few roundings; returns the model's outputs."""
    (lim, wait), (lim0, bud0), thr = _plain(args)
    got = _update_model(args)
    assert _same_bits(got["lim0"], lim0.numpy()), "the taper's lim"
    assert _same_bits(got["budget"], bud0.numpy()), "the taper's budget"
    assert np.array_equal(got["wait"], wait.numpy()), np.flatnonzero(
        got["wait"] != wait.numpy())
    assert _same_bits(got["lim"], lim.numpy()), np.flatnonzero(
        got["lim"].view(np.int32) != lim.numpy().view(np.int32))
    want = float(thr)
    assert abs(float(got["thr"]) - want) <= 4e-7 * abs(want)
    return got


def _reach(got: dict, name: str, args: tuple) -> None:
    """Each crafted case reaches what it was made for."""
    lim, lim0, budget = got["lim"], got["lim0"], got["budget"]
    n = len(lim)
    strong_bins = int((lim0 > 0).sum() + (budget > 0).sum())
    if name == "quiet":
        assert not (lim0 != 0).any() and (lim < 0).any()
    elif name == "one-strong":
        assert 0 < (budget > 0).sum() <= 3
    elif name == "band-edges":
        assert lim0[0] > 0 and lim0[-1] > 0 and lim0[n // 2] > 0
        assert lim0[n // 2 - 1] > 0                # across DC bin 0
    elif name in ("inf", "maxlevel-0"):
        assert ((lim0 == 0) & (budget >= 1)).any()  # the window loop
    elif name == "passband":
        lo, hi = int(args[3]), int(args[4])
        assert (lim[lo:hi + 1] == 0).all() and (got["wait"][lo:hi + 1]
                                                == 0).all()
        assert (np.roll(lim0, -args[7])[lo:hi + 1] > 0).any()
    elif name == "history":
        assert ((got["wait"] > 0) & (got["wait"] < cs.UPDATE_WAIT_N)).any()
        old = args[1].numpy()
        assert ((lim > 0) & (lim == old * F32(1.15))).any()  # the cap
    elif name == "nan":
        assert np.isnan(args[0].numpy()).sum() == 2 and strong_bins
    elif name == "all-strong":
        assert (budget[2:-2] == F32(n / 4 + 1)).all()
    elif name == "long-runs":
        assert budget.max() > 4 * (-(-n // THREADS))
    elif name == "groups-20":
        assert args[-1] == 20 and n % 20 == 0
    assert args[0].shape[0] == n


@pytest.mark.parametrize("name", cs.UPDATE_EDGE_CASES)
def test_update_model_edge_cases(name):
    """The model of the two kernels, bit for bit against the plain
    version on chip_smoke.py's crafted cases (the arguments phase 3b hands
    the card); each case reaches what it was made for."""
    args = cs.update_edge_args(name, CPU)
    _reach(_assert_model(args), name, args)


def _random_args(rng, n: int) -> tuple:
    """A random spectrum (noise, carriers, sometimes a flat stretch and
    ties) and a random old state, IQ or real, a passband or none."""
    k = np.arange(n)
    p = 1e3 * rng.chisquare(int(rng.integers(2, 8)), size=n) / 4
    for _ in range(int(rng.integers(0, 12))):
        p += 10 ** rng.uniform(6, 12) * np.exp(
            -0.5 * ((k - rng.uniform(0, n)) / rng.uniform(0.3, 60)) ** 2)
    if rng.uniform() < 0.3:
        a = int(rng.integers(0, n - 50))
        p[a:a + int(rng.integers(2, 50))] = 10 ** rng.uniform(7, 11)
    u = rng.uniform(size=n)
    lim = np.where(u < 0.15, -1.0, np.where(
        u < 0.45, 10 ** rng.uniform(-3, 0.5, size=n), 0.0)).astype(F32)
    wait = rng.integers(0, 30, size=n).astype(np.int32)
    sel = (None, None)
    if rng.uniform() < 0.7:
        lo = int(rng.integers(-20, n))
        sel = (torch.tensor(lo), torch.tensor(lo + int(rng.integers(0, 40))))
    return (torch.from_numpy(p.astype(F32)), torch.from_numpy(lim),
            torch.from_numpy(wait), *sel,
            float(F32(10 ** rng.uniform(6, 10))), 30.0,
            n // 2 if rng.uniform() < 0.8 else 0, int(rng.integers(1, 12)),
            int(rng.choice([8, 16, 32])))


@pytest.mark.parametrize("seed", range(8))
def test_update_model_random(seed):
    """Random spectra and states at n 512 to 4,096: the model bit for bit
    against the plain version."""
    rng = np.random.default_rng(700 + seed)
    for n in (512, 2048, 1024 + 512, 4096):
        _assert_model(_random_args(rng, n))


def test_update_model_successive_updates():
    """Updates in a row, each from the last one's state: a carrier that
    stops after the third, its counters counting down to 0 while its
    bins stay with the strong channel, the model bit for bit against the
    plain version at each."""
    base = cs.update_edge_args("one-strong", CPU)
    n = base[0].shape[0]
    lim, wait = base[1], base[2]
    rng = np.random.default_rng(5)
    held = []
    for step in range(4 + cs.UPDATE_WAIT_N):
        p = base[0].clone()
        p[1200:1206] = 1e11 if step < 3 else p[1200:1206]
        p *= torch.from_numpy(rng.uniform(0.9, 1.1, size=n).astype(F32))
        args = (p, lim, wait, *base[3:])
        got = _assert_model(args)
        lim, wait = torch.from_numpy(got["lim"]), torch.from_numpy(
            got["wait"])
        held.append(int(wait[1200:1206].max()))
    assert held[2] == cs.UPDATE_WAIT_N
    assert held[3:3 + cs.UPDATE_WAIT_N] == list(
        range(cs.UPDATE_WAIT_N - 1, -1, -1))


def test_update_model_two_channels():
    """The EME path's geometry (fft1 4,096, two channels summed, its own
    limit and hold count) through update_liminfo: the CPU's call is the
    plain version's, and the model with the same constants its bits."""
    from linrad_tpu_torch import derive_geometry
    geo = derive_geometry(cs.eme_params("pallas"))
    assert geo.channels == 2 and geo.fft1_size == 4096
    rng = np.random.default_rng(9)
    k = np.arange(geo.fft1_size)
    power = 1e3 * rng.chisquare(4, size=(geo.fft1_size, 2)) / 4
    power[:, 0] += 3e11 * np.exp(-0.5 * ((k - 1000) / 2.0) ** 2)
    avg = torch.from_numpy(power.astype(F32)).sum(-1)
    state = sl.SellimState.create(geo, CPU)
    lo, hi = torch.tensor(30), torch.tensor(60)
    for _ in range(3):
        new = sl.update_liminfo(geo, state, avg, 8.0, ston=30.0, sel_lo=lo,
                                sel_hi=hi)
        calls = cs.record_calls(sl, "sellim_update", lambda: sl.update_liminfo(
            geo, state, avg, 8.0, ston=30.0, sel_lo=lo, sel_hi=hi))
        (args,) = calls
        got = _assert_model(args)
        assert _same_bits(got["lim"], new.liminfo.numpy())
        assert (got["lim"] > 0).any()
        state = new


def test_vmap_cpu():
    """vmap over 8 crafted streams, a passband each and then one shared:
    the plain version per stream, bit-equal to separate calls."""
    crafted = [cs.update_edge_args(c, CPU) for c in cs.UPDATE_VMAP_CASES]
    lo = torch.tensor(1500)
    stacked = tuple(torch.stack([c[i] for c in crafted]) for i in range(3))
    sels = tuple(torch.stack([c[i] if c[i] is not None else lo + i - 3
                              for c in crafted]) for i in (3, 4))
    const = crafted[0][5:]
    for sel, dims in ((sels, (0, 0)), ((lo, lo + 9), (None, None))):
        got = torch.func.vmap(sl.sellim_update, in_dims=(0, 0, 0, *dims)
                              + (None,) * 5)(*stacked, *sel, *const)
        for r in range(len(crafted)):
            one = tuple(s if d is None else s[r] for s, d in zip(sel, dims))
            want = sl.sellim_update(*(x[r] for x in stacked), *one, *const)
            assert all(torch.equal(a[r], b) for a, b in zip(got, want))


def test_update_liminfo_is_the_operator():
    """update_liminfo calls the module's sellim_update (what the card's
    kernels or a patched plain version answer), and returns its two
    tensors as the new state."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    geo = derive_geometry(flagship_params())
    state = sl.SellimState.create(geo, CPU)
    avg = torch.from_numpy(cs.update_edge_case("band-edges")["p"])
    calls = cs.record_calls(sl, "sellim_update", lambda: sl.update_liminfo(
        geo, state, avg, 8.0))
    (args,) = calls
    assert args[5] == float(F32(sl.sellim_limit(geo, 8.0)))
    assert args[7:] == (geo.fft1_size // 2, args[8], 32) and args[8] >= 2
    lim, wait = sl._update_liminfo_reference(*args)
    new = sl.update_liminfo(geo, state, avg, 8.0)
    assert torch.equal(new.liminfo, lim) and torch.equal(new.liminfo_wait,
                                                         wait)


@pytest.mark.parametrize("change", ["dtype", "wait-dtype", "shape", "2-d",
                                    "one-sel", "float-sel", "half",
                                    "groups", "group-size"])
def test_refusals(change):
    """What sellim_update refuses on any device, naming itself."""
    args = list(cs.update_edge_args("passband", CPU))
    if change == "dtype":
        args[0] = args[0].double()
    elif change == "wait-dtype":
        args[2] = args[2].long()
    elif change == "shape":
        args[1] = args[1][:-1]
    elif change == "2-d":
        args[:3] = [x[None] for x in args[:3]]
    elif change == "one-sel":
        args[4] = None
    elif change == "float-sel":
        args[3] = args[3].float()
    elif change == "half":
        args[7] = 3
    elif change == "groups":
        args[9] = 3
    else:
        args[9] = 1024
    with pytest.raises(ValueError, match="^sellim_update: "):
        sl.sellim_update(*args)


@pytest.mark.parametrize("change", ["groups", "int32-sel", "device"])
def test_card_wrapper_refusals_before_a_launch(change):
    """What the card's wrapper refuses before it launches anything: more
    groups than the front kernel's warps, an int32 passband, tensors on
    two devices."""
    args = list(cs.update_edge_args("passband", CPU))
    args[:3] = [x[None] for x in args[:3]]
    if change == "groups":
        args[9] = 64
        match = "at most 32 groups"
    elif change == "int32-sel":
        args[3:5] = [x.int() for x in args[3:5]]
        match = "int64 passband"
    else:
        args[3] = args[3].to("meta")
        match = "different devices"
    with pytest.raises(ValueError, match=f"^sellim_update: .*{match}"):
        sl._update_launch(*args)


# ---- on the card -------------------------------------------------------

def _card_same(args: tuple) -> None:
    """The kernels against the plain version on the card, bit for bit,
    and a second call the same; the front kernel's threshold the plain
    version's."""
    before = (sl.update_count.launches, sl.taper_count.launches)
    got = sl.sellim_update(*args)
    assert (sl.update_count.launches - before[0],
            sl.taper_count.launches - before[1]) == (2, 1)
    again = sl.sellim_update(*args)
    want = sl._update_liminfo_reference(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert cs.same_bits(a, b) and cs.same_bits(a, c)
    scratch = {}
    sl._update_launch(*(x[None] for x in args[:3]), *args[3:],
                      scratch=scratch)
    assert cs.same_bits(scratch["thr"][0], cs.card_floor_thr(args))


@pytest.mark.card
@pytest.mark.parametrize("name", cs.UPDATE_EDGE_CASES)
def test_card_update_edge_cases(card, name):
    """Every crafted case: the kernels' liminfo and liminfo_wait are the
    plain version's bits on the card."""
    _card_same(cs.update_edge_args(name, card))


@pytest.mark.card
def test_card_update_chain_inputs(card):
    """The arguments of eager flagship (2,048 bins) and EME (4,096, two
    channels summed) steps on the card: the kernels bit for bit against
    the plain version."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    p = flagship_params(fft1_variant="pallas")
    flagship = cs.loop_args(p, cs.make_input(derive_geometry(p), seed=6,
                                             steps=3), cs.TUNE_HZ, 3)[3]
    pe = cs.eme_params("pallas")
    eme = cs.loop_args(pe, cs.make_eme_input(derive_geometry(pe), 3),
                       cs.EME_TUNE_HZ, 3)[3]
    assert flagship[-1][0].shape[0] == 2048 and eme[-1][0].shape[0] == 4096
    for args in flagship + eme:
        _card_same(args)


@pytest.mark.card
def test_card_update_vmap(card):
    """vmap over 8 crafted streams: one launch of each kernel, the same
    bits as 8 separate calls and as the plain version."""
    crafted = [cs.update_edge_args(c, card) for c in cs.UPDATE_VMAP_CASES]
    lo = torch.tensor(1500, device=card)
    stacked = tuple(torch.stack([c[i] for c in crafted]) for i in range(3)) \
        + tuple(torch.stack([c[i] if c[i] is not None else lo + i - 3
                             for c in crafted]) for i in (3, 4))
    const = crafted[0][5:]
    before = (sl.update_count.launches, sl.taper_count.launches)
    got = torch.func.vmap(sl.sellim_update, in_dims=(0,) * 5 + (None,) * 5)(
        *stacked, *const)
    assert (sl.update_count.launches - before[0],
            sl.taper_count.launches - before[1]) == (2, 1)
    for r in range(len(crafted)):
        one = tuple(x[r] for x in stacked)
        each = sl.sellim_update(*one, *const)
        want = sl._update_liminfo_reference(*one, *const)
        for a, b, c in zip(got, each, want):
            assert cs.same_bits(a[r], b) and cs.same_bits(b, c)


@pytest.mark.card
def test_card_update_one_call_a_replay(card):
    """trace.report() reads the two kernels recorded once each in every
    graph of a graphed flagship Receiver, and once each in the step graph
    of a FleetRunner of 8 streams."""
    from linrad_tpu_torch import flagship_params
    from linrad_tpu_torch.parallel import FleetRunner
    from linrad_tpu_torch.pipeline.receiver import Receiver
    from linrad_tpu_torch.utils import trace

    def captured() -> int:
        return trace.report()["counters"]["launches"]["sellim_update"][1]

    recorded = lambda: sl.update_count.captured
    c0 = captured()
    rx = Receiver(flagship_params(), device=card, recorded=recorded)
    assert rx.graphs and all(g.kernels == 2 for g in rx.graphs.values())
    assert captured() - c0 == 2 * len(rx.graphs)
    c1 = captured()
    fleet = FleetRunner(flagship_params(), 8, k_steps=2, device=card,
                        recorded=recorded)
    assert fleet.kernels_per_replay == 2 and captured() - c1 == 2


@pytest.mark.card
def test_card_refusals(card):
    """On the card: 64 groups, an int32 passband and a passband on the
    CPU are refused before a launch."""
    args = list(cs.update_edge_args("passband", card))
    before = sl.update_count.launches
    for change in ("groups", "int32", "cpu"):
        bad = list(args)
        if change == "groups":
            bad[9] = 64
        elif change == "int32":
            bad[3:5] = [x.int() for x in bad[3:5]]
        else:
            bad[3:5] = [x.cpu() for x in bad[3:5]]
        with pytest.raises(ValueError, match="^sellim_update: "):
            sl.sellim_update(*bad)
    assert sl.update_count.launches == before
