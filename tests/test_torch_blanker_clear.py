"""The stupid blanker as the port runs it on the card: one custom operator,
``ops/blanker.py:blanker_clear``, two launches of ``csrc/blanker_clear.cu``
on a CUDA tensor and its plain version ``_blanker_clear_reference`` (the
run maxima by a segmented scatter, the widening by a suffix minimum and a
prefix maximum over the whole stream) on a CPU tensor.

On the CPU these tests hold:

- a numpy model of the kernel (tiles of ``CLEAR_TILE`` samples, each
  run's maximum inside its tile, the tiles' summaries, the walk across
  tiles that are flagged throughout, the widening as a stencil over halos
  of ``clear_reach(pw)``), bit for bit against the plain version on
  ``chip_smoke.py``'s crafted cases (the arguments phase 3b hands the card)
  and on random streams: weak', pwr' and the count;
- the bound the stencil rests on: t = sqrt(clamp(runmax / nf, 0, 1e4)) /
  100 is at most 1 for every run maximum and floor, +inf and 0 among
  them, with the division by 100 as the CPU and as the card take it, so
  that no reach passes ``clear_reach(pw)``;
- the vmap rule (per stream on the CPU) bit-equal to separate calls, with
  a floor per stream and one shared.

The tests marked ``card`` need a CUDA device (they skip here): the kernel
bit for bit against the plain version on the card, on the arguments of
eager flagship and EME steps, on every crafted case and under vmap over 8
streams against 8 separate calls.  This file imports no JAX and needs
nothing of ``tests/conftest.py``, so that on the machine with the card
``python -m pytest --noconftest tests/test_torch_blanker_clear.py -m card``
runs them.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from linrad_tpu_torch.ops import blanker as bl

CPU = "cpu"
TILE = bl.CLEAR_TILE
F32 = np.float32


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---- the numpy model of the kernel ------------------------------------

def _run_maxima(f: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Each flagged sample's maximum over its run, -inf elsewhere."""
    out = np.full(len(f), -np.inf, F32)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], f.astype(np.int8),
                                                   [0]])))
    for lo, hi in zip(edges[::2], edges[1::2]):
        out[lo:hi] = p[lo:hi].max()
    return out


def _summary(f: np.ndarray, local: np.ndarray) -> tuple:
    """(lead_max, trail_max, lead_end, trail_start) of one tile, as
    clear_runs_kernel writes it."""
    under = np.flatnonzero(~f)
    n = len(f)
    lead_end = int(under[0]) if len(under) else n
    trail_start = int(under[-1]) + 1 if len(under) else 0
    return (local[0] if lead_end > 0 else -np.inf,
            local[-1] if trail_start < n else -np.inf, lead_end,
            trail_start)


def _beyond(summ: list, u: int, right: bool) -> float:
    """The maximum of the run continuing past tile u's left or right edge:
    the neighbours' edge runs while each is flagged throughout."""
    acc = -np.inf
    step = 1 if right else -1
    v = u + step
    while 0 <= v < len(summ):
        lead_max, trail_max, _le, trail_start = summ[v]
        acc = max(acc, lead_max if right else trail_max)
        if trail_start != 0:
            break
        v += step
    return acc


def _t(runmax: np.ndarray, nf: np.float32, card: bool) -> np.ndarray:
    """t in float32, one rounding a step: the division by 100 true on the
    CPU, a product with the float reciprocal of 100 on the card."""
    denom = nf if np.isnan(nf) else max(nf, F32(1e-20))
    with np.errstate(all="ignore"):
        q = np.minimum(np.maximum(runmax / denom, F32(0)),
                       F32(bl.CLEAR_CLAMP))
        root = np.sqrt(q)
        return root * (F32(1) / F32(100)) if card else root / F32(100)


def _clear_model(weak: np.ndarray, pwr: np.ndarray, nf, limit_amp: float,
                 pw: int, card: bool = False) -> tuple:
    """The kernel on one stream: (weak', pwr', count)."""
    s = len(pwr)
    nf = F32(nf)
    with np.errstate(invalid="ignore", over="ignore"):
        thr = nf * F32(limit_amp * limit_amp)
        flagged = pwr > thr
    local = np.full(s, -np.inf, F32)
    summ = []
    for t0 in range(0, s, TILE):
        f, p = flagged[t0:t0 + TILE], pwr[t0:t0 + TILE]
        local[t0:t0 + TILE] = _run_maxima(f, p)
        summ.append(_summary(f, local[t0:t0 + TILE]))
    runmax = local.copy()
    for u, (_lm, _tm, lead_end, trail_start) in enumerate(summ):
        t0 = u * TILE
        n = len(flagged[t0:t0 + TILE])
        lead = slice(t0, t0 + lead_end)
        trail = slice(t0 + trail_start, t0 + n)
        runmax[lead] = np.maximum(runmax[lead], _beyond(summ, u, False))
        runmax[trail] = np.maximum(runmax[trail], _beyond(summ, u, True))
    runmax = np.where(flagged, runmax, -np.inf).astype(F32)
    with np.errstate(over="ignore"):
        widen = flagged & (runmax > F32(4) * nf)
    t = _t(runmax, nf, card)
    kb, ka = F32((pw + 1) // 2), F32(pw + 1)
    before = kb * t + F32(0.5)
    after = ka * t + F32(0.5)
    pos = np.arange(s, dtype=F32)
    rl = np.where(widen, pos - before, np.inf).astype(F32)
    rr = np.where(widen, pos + after, -np.inf).astype(F32)
    right, left = bl.clear_reach(pw)
    cleared = flagged.copy()
    for k in range(1, right + 1):
        cleared[:-k] |= rl[k:] <= pos[:-k]
    for k in range(1, left + 1):
        cleared[k:] |= rr[:-k] >= pos[k:]
    return (np.where(cleared[:, None], np.complex64(0), weak),
            np.where(cleared, F32(0), pwr), int(cleared.sum()))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if np.iscomplexobj(a):
        a, b = a.view(np.float32), b.view(np.float32)
    return a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _assert_model(weak, pwr, nf, limit, pw) -> int:
    """The model against the plain version on the CPU, bit for bit;
    returns the count."""
    want = bl._blanker_clear_reference(
        torch.from_numpy(weak), torch.from_numpy(pwr),
        torch.tensor(nf, dtype=torch.float32), limit, pw)
    got = _clear_model(weak, pwr, nf, limit, pw)
    assert _same_bits(got[0], want[0].numpy()), "weak"
    assert _same_bits(got[1], want[1].numpy()), np.flatnonzero(
        got[1].view(np.int32) != want[1].numpy().view(np.int32))
    assert want[2].dtype == torch.int32 and got[2] == int(want[2])
    return got[2]


@pytest.mark.parametrize("name", cs.CLEAR_EDGE_CASES)
def test_clear_model_edge_cases(name):
    """The model of the kernel, bit for bit against the plain version on
    chip_smoke.py's crafted cases (the arguments phase 3b hands the
    card); each case reaches what it was made for."""
    weak, pwr, nf, limit, pw = cs.clear_edge_case(name)
    count = _assert_model(weak, pwr, nf, limit, pw)
    s = len(pwr)
    if name == "quiet":
        assert count == 0
    elif name == "all-flagged":
        assert count == s and bool((pwr > nf * F32(limit * limit)).all())
    else:
        assert 0 < count < s
    if name == "ragged":
        assert s % TILE
    if name == "wide-pulse":
        assert bl.clear_reach(pw) == (15, 31)
    if name == "long-run":
        flagged = pwr > nf * F32(limit * limit)
        runs = np.diff(np.flatnonzero(np.diff(np.concatenate(
            [[0], flagged.astype(np.int8), [0]]))))[::2]
        assert runs.max() > 2 * TILE


def test_clear_model_vmap_case():
    """The crafted streams that phase 3b stacks under vmap: each its own
    floor, the model bit for bit against the plain version per stream."""
    weak, pwr, floors, limit, pw = cs.clear_vmap_args(CPU)
    assert len(weak) == len(cs.CLEAR_VMAP_CASES)
    assert len(set(floors.tolist())) == len(floors)
    for i in range(len(weak)):
        _assert_model(weak[i].numpy(), pwr[i].numpy(),
                      floors[i].numpy(), limit, pw)


def _random_clear_case(rng) -> tuple:
    """A stream of 1-4 channels and 600-3,000 samples: noise at a floor
    of 0 to 1e3 (now and then 0), runs of 1-900 samples at 1 to 1e6 floors
    (+inf, NaN and exact multiples of the floor among them), a limit of
    1.2-6 and a width of 0-40."""
    s = int(rng.integers(600, 3001))
    c = int(rng.integers(1, 5))
    nf = F32(0.0 if rng.random() < 0.1 else 10 ** rng.uniform(-3, 3))
    x = np.sqrt(max(nf, 1.0) / (2 * c)) * (rng.normal(size=(s, c))
                                           + 1j * rng.normal(size=(s, c)))
    if rng.random() < 0.15:
        x[:] = 0.0
    weak = x.astype(np.complex64)
    pwr = (np.abs(weak) ** 2).sum(1).astype(F32)
    floor = max(nf, F32(1.0))
    for _ in range(int(rng.integers(0, 30))):
        lo = int(rng.integers(0, s))
        n = int(rng.choice([1, 2, 3, 5, 40, 600, 900]))
        level = F32(floor * 10 ** rng.uniform(0, 6))
        pwr[lo:lo + n] = level * rng.uniform(0.5, 1, min(n, s - lo))
        u = rng.random()
        if u < 0.05:
            pwr[lo] = np.inf
        elif u < 0.1:
            pwr[lo] = np.nan
        elif u < 0.2:
            pwr[lo] = F32(4) * nf
        elif u < 0.3:
            pwr[lo] = F32(1e4) * nf
    limit = float(rng.choice([1.2, 1.5, 2.0, 4.0, 6.0]))
    pw = int(rng.choice([0, 1, 2, 3, 7, 30, 40]))
    return weak, pwr, nf, limit, pw


@pytest.mark.parametrize("seed", range(6))
def test_clear_model_random(seed):
    """The model against the plain version, bit for bit, on 25 random
    streams per seed."""
    rng = np.random.default_rng(7000 + seed)
    for _ in range(25):
        _assert_model(*_random_clear_case(rng))


def test_clear_model_flagship_width():
    """Flagship-sized streams (65,536 samples, pw 2) at the flagship's
    limit, a floor of 100 and 40 impulses widened across tile edges: the
    model bit for bit against the plain version."""
    rng = np.random.default_rng(11)
    s = 65_536
    weak = (np.sqrt(50.0) * (rng.normal(size=(s, 1))
                             + 1j * rng.normal(size=(s, 1)))
            ).astype(np.complex64)
    pwr = (np.abs(weak) ** 2).sum(1).astype(F32)
    for lo in np.concatenate([rng.integers(0, s - 8, 32),
                              np.arange(1, 9) * 4 * TILE - 2]):
        pwr[lo:lo + 4] = F32(100 * 10 ** rng.uniform(1.3, 5))
    assert 0 < _assert_model(weak, pwr, F32(100), 4.0, 2) < s


@pytest.mark.parametrize("pw", [0, 1, 2, 3, 30, bl.CLEAR_MAX_PW])
def test_clear_reach_bounds_t(pw):
    """The premise of the stencil: t <= 1 for every run maximum and floor
    (0, subnormal, +inf and NaN among them), with the division by 100 as
    the CPU's plain version and as the card take it, so that before and
    after never pass clear_reach(pw) + 0.5; and the plain version's own t
    matches the model's."""
    runmax = np.array([0, 1e-45, 1e-30, 1, 399.99997, 400, 1e4, 99999.99,
                       1e5, 1e6, 3.4e38, np.inf, -1, -np.inf], F32)
    right, left = bl.clear_reach(pw)
    assert (right, left) == ((pw + 1) // 2, pw + 1)
    for nf in map(F32, (0, 1e-45, 1e-20, 1e-3, 1, 100, 3e38, np.inf)):
        for card in (False, True):
            t = _t(runmax, nf, card)
            finite = t[~np.isnan(t)]
            assert (finite >= 0).all() and (finite <= 1).all()
            before = F32((pw + 1) // 2) * finite + F32(0.5)
            after = F32(pw + 1) * finite + F32(0.5)
            assert (before <= right + 0.5).all()
            assert (after <= left + 0.5).all()
        plain = torch.sqrt(torch.clamp(
            torch.from_numpy(runmax) / torch.clamp(
                torch.tensor(nf), min=1e-20), 0.0, bl.CLEAR_CLAMP)) / 100.0
        # the same values (a zero's sign aside: t = -0 widens as 0 does)
        assert np.array_equal(plain.numpy(), _t(runmax, nf, False),
                              equal_nan=True)
    # the clamp's top gives t = 1 exactly on both sides
    top = np.array([bl.CLEAR_CLAMP], F32)
    assert _t(top, F32(1), False)[0] == 1 == _t(top, F32(1), True)[0]


def test_clear_vmap_cpu():
    """The vmap rule on the CPU: the plain version per stream, bit-equal
    to separate calls, with a floor per stream and with one shared."""
    weak, pwr, floors, limit, pw = cs.clear_vmap_args(CPU)
    got = torch.func.vmap(bl.blanker_clear, in_dims=(0, 0, 0, None, None))(
        weak, pwr, floors, limit, pw)
    shared = torch.func.vmap(bl.blanker_clear,
                             in_dims=(0, 0, None, None, None))(
        weak, pwr, floors[1], limit, pw)
    for i in range(len(weak)):
        for out, nf in ((got, floors[i]), (shared, floors[1])):
            want = bl.blanker_clear(weak[i], pwr[i], nf, limit, pw)
            assert all(_same_bits(a[i].numpy(), b.numpy())
                       for a, b in zip(out, want))


def test_stupid_blanker_is_the_operator():
    """stupid_blanker hands its arguments to the operator (limit as a
    float), so the chain's calls reach the kernel on the card."""
    weak, pwr, nf, limit, pw = cs.clear_edge_args("long-run", CPU)
    before = (bl.clear_count.launches, bl.clear_count.captured)
    a = bl.stupid_blanker(weak, pwr, nf, int(limit), pw)
    b = bl.blanker_clear(weak, pwr, nf, limit, pw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (bl.clear_count.launches, bl.clear_count.captured) == before


# ---- on the card ------------------------------------------------------

def _card_same(args: tuple) -> None:
    """The kernel against the plain version on the card, bit for bit, and
    a second launch the same."""
    got = bl.blanker_clear(*args)
    again = bl.blanker_clear(*args)
    want = bl._blanker_clear_reference(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert cs.same_bits(a, b) and cs.same_bits(a, c)


@pytest.mark.card
@pytest.mark.parametrize("name", cs.CLEAR_EDGE_CASES)
def test_card_clear_edge_cases(card, name):
    """Every crafted case: the kernel's weak', pwr' and count are the
    plain version's bits on the card."""
    before = bl.clear_count.launches
    _card_same(cs.clear_edge_args(name, card))
    assert bl.clear_count.launches == before + 2


@pytest.mark.card
def test_card_clear_chain_inputs(card):
    """The arguments of eager flagship (65,536 x 1) and EME (131,072 x 2)
    steps on the card: the kernel bit for bit against the plain version."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    p = flagship_params(fft1_variant="pallas")
    flagship = cs.loop_args(p, cs.make_input(derive_geometry(p), seed=6,
                                             steps=3), cs.TUNE_HZ, 3)[2]
    pe = cs.eme_params("pallas")
    eme = cs.loop_args(pe, cs.make_eme_input(derive_geometry(pe), 3),
                       cs.EME_TUNE_HZ, 3)[2]
    assert tuple(flagship[-1][0].shape) == (65_536, 1)
    assert tuple(eme[-1][0].shape) == (131_072, 2)
    for args in flagship + eme:
        _card_same(args)


@pytest.mark.card
def test_card_clear_vmap(card):
    """vmap over 8 streams, each with its own floor: one call, the same
    bits as 8 separate calls and as the plain version."""
    weak, pwr, floors, limit, pw = cs.clear_vmap_args(card)
    before = bl.clear_count.launches
    got = torch.func.vmap(bl.blanker_clear, in_dims=(0, 0, 0, None, None))(
        weak, pwr, floors, limit, pw)
    assert bl.clear_count.launches == before + 1
    for i in range(len(weak)):
        each = bl.blanker_clear(weak[i], pwr[i], floors[i], limit, pw)
        want = bl._blanker_clear_reference(weak[i], pwr[i], floors[i],
                                           limit, pw)
        for a, b, c in zip(got, each, want):
            assert cs.same_bits(a[i], b) and cs.same_bits(b, c)


@pytest.mark.card
def test_card_clear_one_call_a_replay(card):
    """trace.report() reads one blanker_clear call recorded in each graph
    of a graphed flagship Receiver, and one in the step graph of a
    FleetRunner of 8 streams: one call per replay, for the 8 streams
    together."""
    from linrad_tpu_torch import flagship_params
    from linrad_tpu_torch.parallel import FleetRunner
    from linrad_tpu_torch.pipeline.receiver import Receiver
    from linrad_tpu_torch.utils import trace

    def captured() -> int:
        return trace.report()["counters"]["launches"]["blanker_clear"][1]

    recorded = lambda: bl.clear_count.captured
    c0 = captured()
    rx = Receiver(flagship_params(), device=card, recorded=recorded)
    assert rx.graphs and all(g.kernels == 1 for g in rx.graphs.values())
    assert captured() - c0 == len(rx.graphs)
    c1 = captured()
    fleet = FleetRunner(flagship_params(), 8, k_steps=2, device=card,
                        recorded=recorded)
    assert fleet.kernels_per_replay == 1 and captured() - c1 == 1

