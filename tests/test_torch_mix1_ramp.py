"""mix1's fractional-bin ramp as the port runs it on the card: one custom
operator, ``ops/mix1.py:mix1_ramp`` (what ``frac_ramp`` calls), one launch
of ``csrc/mix1_ramp.cu`` on a CUDA tensor and its plain version
``_frac_ramp_reference`` (the sums in XLA's CPU order as small tensor
operations, ``utils/fporder.py``) on a CPU tensor.

On the CPU these tests hold:

- a numpy model of the kernel (the prefix sum's levels of 16, each block's
  sequential prefix, the totals scanned level by level and added back from
  the top down; the phase's sum in blocks of 32 padded at both ends; each
  thread's blocks; the per-sample increment, the wrap and the angle in
  float32, cos and sin the platform's) bit for bit against
  ``ordered_cumsum``, ``ordered_sum`` and the plain version on
  ``chip_smoke.py``'s crafted cases (``RAMP_CASES``: lengths 1 to 65,536,
  1, 8 and 24 rows, a fraction a row or a frame, with and without a slope);
- the operator on the CPU against the plain version, the fake (shapes and
  dtypes, ``torch.library.opcheck``), the vmap rule against separate calls,
  and what the operator and the card's wrapper refuse.

The tests marked ``card`` need a CUDA device (they skip here): every
crafted case bit for bit against the plain version on the card, eagerly,
replayed from a CUDA graph and under vmap of 8 streams; the kernel's
shared-memory plan; a graphed flagship ``Receiver`` tuned between bins and
the EME ``Receiver`` through the AFC's per-frame fractions and slopes, each
bit-equal over its steps to the same receiver on the plain ramp and to its
eager step; one call recorded a replay.  This file imports no JAX and
needs nothing of ``tests/conftest.py``, so that on the machine with the
card ``python -m pytest --noconftest tests/test_torch_mix1_ramp.py -m
card`` runs them.
"""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke as cs
from linrad_tpu_torch.ops import mix1 as mx
from linrad_tpu_torch.utils.fporder import ordered_cumsum, ordered_sum

F32 = np.float32
PREFIX, SUM = 16, 32     # the kernel's kPrefix and kSum
MAX_THREADS = 1024       # the kernel's kMaxThreads
SHARED_MAX = 227 * 1024  # the card's shared memory a block with an opt-in


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(torch.view_as_real(a) if a.is_complex()
                               else a.view(torch.int32),
                               torch.view_as_real(b) if b.is_complex()
                               else b.view(torch.int32))
               for a, b in zip(got, want))


# ---- the numpy model of the kernel -------------------------------------

def _threads(length: int) -> int:
    """The kernel's threads_for: ceil(L / 4) rounded up to a warp, 32 to
    1,024."""
    return min(max(-(-(-(-length // 4)) // 32) * 32, 32), MAX_THREADS)


def _owned(nt: int, blocks: int, from_top: bool = False) -> list:
    """The blocks each of nt threads takes, t, t + nt, ... (the sum's from
    the last thread down)."""
    return [list(range(nt - 1 - t if from_top else t, blocks, nt))
            for t in range(nt)]


def _plan(length: int) -> dict:
    """The kernel's levels for a row of ``length`` samples, as its
    make_plan lays them out: ``prefix`` the prefix sum's level sizes
    (length, then ceil(/16) while above 16), ``sums`` the sum's (length,
    then ceil(/32) while above 32), ``words`` the shared memory they take
    above level 0."""
    prefix, sums = [length], [length]
    while prefix[-1] > PREFIX:
        prefix.append(-(-prefix[-1] // PREFIX))
    while sums[-1] > SUM:
        sums.append(-(-sums[-1] // SUM))
    return {"prefix": prefix, "sums": sums,
            "words": sum(prefix[1:]) + sum(sums[1:])}


def _per_sample(fr, sl, n, m, hop, divide: bool) -> np.ndarray:
    """x (rows, L): frame i // hop's fraction over m; with a slope the
    fraction plus the slope over m times (j + 0.5) / hop - 0.5, in float64,
    rounded once.  ``divide``: a true division by m and hop, as the CPU
    takes a Python scalar divisor; else the product with the float
    reciprocal, as the card and the kernel take it."""
    i = np.arange(n * hop)
    f, j = i // hop, i % hop

    def over(x, d):
        return x / F32(d) if divide else x * (F32(1) / F32(d))

    x = over(fr[:, f], m).astype(F32)
    if sl is None:
        return x
    pos = (over(j.astype(F32) + F32(0.5), hop) - F32(0.5)).astype(F32)
    s = over(sl[:, f], m).astype(F32)
    return (x.astype(np.float64) + s.astype(np.float64)
            * pos.astype(np.float64)).astype(F32)


def _block_prefix(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each block of 16 of v (rows, n) in sequence, zero-padded at the end:
    (the inclusive prefixes (rows, n), the blocks' totals)."""
    rows, n = v.shape
    nb = -(-n // PREFIX)
    w = np.zeros((rows, nb * PREFIX), F32)
    w[:, :n] = v
    w = w.reshape(rows, nb, PREFIX)
    for q in range(1, PREFIX):
        w[:, :, q] = w[:, :, q - 1] + w[:, :, q]
    return w.reshape(rows, -1)[:, :n], w[:, :, -1].copy()


def _sequential(v: np.ndarray) -> np.ndarray:
    out = v.copy()
    for i in range(1, v.shape[1]):
        out[:, i] = out[:, i - 1] + v[:, i]
    return out


def _add_before(v: np.ndarray, above: np.ndarray) -> np.ndarray:
    """v[i] + the level above's prefix at the block before i's (0 for the
    first block)."""
    b = np.arange(v.shape[1]) // PREFIX
    before = np.where(b > 0, above[:, np.maximum(b - 1, 0)], F32(0))
    return (v + before).astype(F32)


def _model_prefix(x: np.ndarray, plan: dict) -> np.ndarray:
    """The kernel's prefix sum: level 0's totals; each level k above in
    place (block prefixes, totals to k + 1); the top level in sequence;
    the levels added back from the top down; level 0's prefix plus the
    total before its block."""
    sizes = plan["prefix"]
    top = len(sizes) - 1
    if top == 0:
        return _sequential(x)
    inner0, level = _block_prefix(x)
    levels = [None, level]
    for k in range(1, top):
        inner, totals = _block_prefix(levels[k])
        levels[k] = inner
        levels.append(totals)
    assert [lv.shape[1] for lv in levels[1:]] == sizes[1:]
    levels[top] = _sequential(levels[top])
    for k in range(top - 1, 0, -1):
        levels[k] = _add_before(levels[k], levels[k + 1])
    return _add_before(inner0, levels[1])


def _model_sum(x: np.ndarray, plan: dict) -> np.ndarray:
    """The kernel's phase sum: while more than 32 values are left, blocks
    of 32 summed in sequence, the padding split between both ends (the
    smaller half in front); then the last values in sequence."""
    v = x
    for size in plan["sums"][1:]:
        n = v.shape[1]
        pad = -n % SUM
        lo = pad // 2
        w = np.zeros((v.shape[0], size * SUM), F32)
        w[:, lo:lo + n] = v
        v = _sequential(w.reshape(-1, SUM))[:, -1].reshape(v.shape[0], size)
    return _sequential(v)[:, -1]


def _wrap(x: np.ndarray) -> np.ndarray:
    """torch.remainder(x, 1.0) for float32: fmod, then + 1 where negative
    and not 0."""
    mod = np.fmod(x, F32(1))
    return np.where((mod != 0) & (mod < 0), mod + F32(1), mod).astype(F32)


def _model(frac_phase, tune_frac, tune_slope, n, m, hop, divide=True):
    """The kernel on numpy: returns (prefix, phase sum, ramp, new phase)
    with the operator's shapes (cos and sin the platform's torch)."""
    lead = tuple(frac_phase.shape)
    full = lead + (n,)
    fp = frac_phase.numpy().astype(F32).reshape(-1)
    rows = fp.size
    fr = np.broadcast_to(tune_frac.numpy(), full).reshape(rows, n)
    sl = None if tune_slope is None else np.broadcast_to(
        tune_slope.numpy(), full).reshape(rows, n)
    x = _per_sample(fr, sl, n, m, hop, divide)
    plan = _plan(n * hop)
    pre = _model_prefix(x, plan)
    total = _model_sum(x, plan)
    theta = (F32(-2.0 * math.pi) * _wrap((fp[:, None] + pre) - x)).astype(F32)
    th = torch.from_numpy(theta)
    ramp = torch.complex(torch.cos(th), torch.sin(th))
    phase = torch.from_numpy(_wrap(fp + total))
    length = n * hop
    return (torch.from_numpy(pre), torch.from_numpy(total),
            ramp.reshape(lead + (length,)), phase.reshape(lead)), x


@pytest.mark.parametrize("case", cs.RAMP_CASES, ids=cs.ramp_label)
def test_model_equals_plain(case):
    """The model's prefix and sum are ordered_cumsum's and ordered_sum's
    bits; its ramp and new phase the plain version's, which the operator
    returns on the CPU."""
    args = cs.ramp_args(case, "cpu")
    (pre, total, ramp, phase), x = _model(*args)
    xt = torch.from_numpy(x)
    assert _same((pre, total), (ordered_cumsum(xt), ordered_sum(xt)))
    want = mx._frac_ramp_reference(*args)
    assert _same((ramp, phase), want)
    assert _same(mx.mix1_ramp(*args), want)


def test_cases_reach_every_path():
    """The crafted cases hold every level count of both sums (a row of at
    most 16 and of at most 32 samples, up to three levels above level 0),
    ragged padding at both sums' every level, and the wrap's negative
    branch."""
    prefix_levels, sum_levels, ragged, negative = set(), set(), set(), 0
    for case in cs.RAMP_CASES:
        fp, fr, sl, n, m, hop = cs.ramp_args(case, "cpu")
        plan = _plan(n * hop)
        prefix_levels.add(len(plan["prefix"]) - 1)
        sum_levels.add(len(plan["sums"]) - 1)
        ragged |= {("prefix", k) for k, s in enumerate(plan["prefix"][:-1])
                   if s % PREFIX}
        ragged |= {("sum", k) for k, s in enumerate(plan["sums"][:-1])
                   if s % SUM}
        (pre, _t, _r, _p), x = _model(fp, fr, sl, n, m, hop)
        negative += int(((fp.reshape(-1, 1).numpy() + pre.numpy()) - x
                         < 0).sum())
    assert prefix_levels == {0, 1, 2, 3} and sum_levels == {0, 1, 2, 3}
    assert {("prefix", 0), ("prefix", 1), ("sum", 0),
            ("sum", 1)} <= ragged and negative > 0


@pytest.mark.parametrize("length", sorted(cs.RAMP_SHAPES) + [
    100_000, mx.RAMP_MAX_LEN])
def test_threads_own_every_block_once(length):
    """Every block of 16 of every prefix level, every block of 32 of every
    sum level and every sample of the last pass is one thread's, at the
    kernel's thread count; the levels fit in the card's shared memory; at
    4,096 samples the prefix's 256 runs of 16 and the sum's 128 runs of 32
    fall to distinct threads, 4 samples a thread in the last pass."""
    nt = _threads(length)
    plan = _plan(length)
    firsts = []          # the threads of level 0's chains
    for sizes, base, top in ((plan["prefix"], PREFIX, False),
                             (plan["sums"], SUM, True)):
        for k, size in enumerate(sizes[:-1]):
            blocks = -(-size // base)
            owned = _owned(nt, blocks, top)
            assert sorted(b for bs in owned for b in bs) == list(
                range(blocks))
            if k == 0:
                firsts.append({t for t, bs in enumerate(owned) if bs})
    samples = _owned(nt, length)
    assert sorted(i for bs in samples for i in bs) == list(range(length))
    assert 4 * plan["words"] <= SHARED_MAX
    if length == 4096:
        assert nt == 1024 and plan["words"] == 404
        assert not firsts[0] & firsts[1]
        assert {len(bs) for bs in samples} == {4}
        assert plan["prefix"] == [4096, 256, 16]
        assert plan["sums"] == [4096, 128, 4]


def test_card_divisor_is_the_cpu_one_at_powers_of_two():
    """The model with the card's reciprocal products equals the model with
    the CPU's divisions wherever m and hop are powers of two (every
    geometry's m; hop in every preset and cell), slope or not."""
    for case in cs.RAMP_CASES:
        args = cs.ramp_args(case, "cpu")
        if args[5] & (args[5] - 1):
            continue
        got = _model(*args, divide=False)[0]
        assert _same(got, _model(*args)[0])


# ---- the operator on the CPU -------------------------------------------

@pytest.mark.parametrize("lead, frac, slope", [
    ((), (), None), ((), (32,), (32,)), ((3,), (3, 1), None),
    ((3,), (32,), (3, 32)), ((2, 3), (3, 32), ())])
def test_fake_shapes_and_dtypes(lead, frac, slope):
    with FakeTensorMode():
        ramp, phase = mx.mix1_ramp(
            torch.empty(lead), torch.empty(frac),
            None if slope is None else torch.empty(slope), 32, 256, 128)
    assert (tuple(ramp.shape), ramp.dtype) == (lead + (4096,),
                                               torch.complex64)
    assert (tuple(phase.shape), phase.dtype) == (lead, torch.float32)


@pytest.mark.parametrize("case", [(4096, 1, False, False),
                                  (4096, 8, True, True), (17, 1, True, True),
                                  (255, 24, False, True)],
                         ids=cs.ramp_label)
def test_opcheck(case):
    checks = ("test_schema", "test_faketensor")
    count = (mx.ramp_count.launches, mx.ramp_count.captured)
    assert torch.library.opcheck(mx.mix1_ramp, cs.ramp_args(case, "cpu"),
                                 test_utils=checks) == dict.fromkeys(
                                     checks, "SUCCESS")
    assert (mx.ramp_count.launches, mx.ramp_count.captured) == count


@pytest.mark.parametrize("dims", [(0, 0, None), (0, None, None), (0, 0, 0),
                                  (None, 0, 0), (0, 1, None)])
def test_vmap_equals_separate_calls(dims):
    """R = 3 streams of (32 frames x 128) ramps under torch.func.vmap, the
    phase, fractions and slopes batched or shared, per-frame fractions
    batched on either axis: each output equals three separate calls,
    stacked."""
    rng = np.random.default_rng(7)
    t = lambda *shape: torch.from_numpy(rng.uniform(
        -0.5, 0.5, shape).astype(F32))
    fp, fr, sl = t(3), t(3, 32), t(3, 32) * 0.1
    args = [x if d is not None else x[0] for x, d in zip((fp, fr, sl), dims)]
    if dims[1] == 1:
        args[1] = fr.T
    got = torch.func.vmap(mx.mix1_ramp, in_dims=dims + (None,) * 3)(
        *args, 32, 256, 128)
    each = [mx.mix1_ramp(*(x if d is None else x.movedim(d, 0)[r]
                           for x, d in zip(args, dims)), 32, 256, 128)
            for r in range(3)]
    assert _same(got, [torch.stack(v) for v in zip(*each)])


def test_frac_ramp_is_the_operator():
    """frac_ramp hands the module's mix1_ramp (what the card's kernel or a
    patched plain version answers) float32 fractions and the geometry's
    mix1 size and new points a frame."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    geo = derive_geometry(flagship_params())
    n = geo.fftx_frames_per_step
    fp = torch.tensor(0.25)
    fr = torch.full((n,), -0.2, dtype=torch.float64)
    calls = cs.record_calls(mx, "mix1_ramp", lambda: mx.frac_ramp(
        geo, fp, fr, None, n))
    (args,) = calls
    assert args[1].dtype == torch.float32 and args[2] is None
    assert args[3:] == (n, geo.mix1_size, geo.mix1_new_points)
    assert _same(mx.frac_ramp(geo, fp, fr, None, n),
                 mx._frac_ramp_reference(*args))


@pytest.mark.parametrize("change", ["phase-dtype", "frac-dtype",
                                    "slope-dtype", "frac-shape",
                                    "slope-shape", "frames", "hop", "m"])
def test_refusals(change):
    """What mix1_ramp refuses on any device, naming itself."""
    args = list(cs.ramp_args((4096, 8, True, True), "cpu"))
    if change == "phase-dtype":
        args[0] = args[0].double()
    elif change == "frac-dtype":
        args[1] = args[1].double()
    elif change == "slope-dtype":
        args[2] = args[2].half()
    elif change == "frac-shape":
        args[1] = args[1][:, :-1]
    elif change == "slope-shape":
        args[2] = args[2][None].expand(2, -1, -1)
    elif change == "frames":
        args[3] = 0
    elif change == "hop":
        args[5] = 0
    else:
        args[4] = 0
    with pytest.raises(ValueError, match="^mix1_ramp: "):
        mx.mix1_ramp(*args)


@pytest.mark.parametrize("change", ["length", "device"])
def test_card_wrapper_refusals_before_a_launch(change):
    """What the card's wrapper refuses before it launches anything: rows
    longer than the kernel's shared memory holds, tensors on two
    devices."""
    fp, fr, sl, n, m, hop = cs.ramp_args((4096, 8, True, True), "cpu")
    if change == "length":
        fr, sl = torch.zeros(()), None
        n = mx.RAMP_MAX_LEN // hop + 1
        match = f"at most {mx.RAMP_MAX_LEN} samples"
    else:
        fr = fr.to("meta")
        match = "different devices"
    with pytest.raises(ValueError, match=f"^mix1_ramp: .*{match}"):
        mx._ramp_launch(fp[None], fr[None], None if sl is None else sl[None],
                        n, m, hop)


# ---- on the card -------------------------------------------------------

def _card_same(args: tuple) -> None:
    """The kernel against the plain version on the card, bit for bit, one
    launch; a second call the same."""
    before = mx.ramp_count.launches
    got = mx.mix1_ramp(*args)
    assert mx.ramp_count.launches == before + 1
    again = mx.mix1_ramp(*args)
    want = mx._frac_ramp_reference(*args)
    torch.cuda.synchronize()
    assert _same(got, again) and _same(got, want)


@pytest.mark.card
@pytest.mark.parametrize("length", sorted(cs.RAMP_SHAPES))
def test_card_ramp_cases(card, length):
    """Every crafted case of this length (1, 8 and 24 rows, a fraction a
    row or a frame, slope or not): the kernel's ramp and new phase are the
    plain version's bits on the card."""
    for case in cs.RAMP_CASES:
        if case[0] == length:
            _card_same(cs.ramp_args(case, card))


@pytest.mark.card
def test_card_plan_is_the_kernels(card):
    """The kernel's shared words at every crafted length and at its largest
    are _plan's."""
    import ctypes
    from linrad_tpu_torch.utils import cuda_build
    words = cuda_build.bind("mix1_ramp", "lrt_mix1_ramp_words",
                            (ctypes.c_int,))
    for length in sorted(cs.RAMP_SHAPES) + [100_000, mx.RAMP_MAX_LEN]:
        assert words(length) == _plan(length)["words"]


@pytest.mark.card
@pytest.mark.parametrize("case", [(4096, 1, False, False),
                                  (4096, 1, True, True),
                                  (4096, 8, False, False),
                                  (65536, 24, True, True)],
                         ids=cs.ramp_label)
def test_card_graph_replay(card, case):
    """The kernel captured into a CUDA graph: one call recorded, the
    replay bit-equal to the eager call and to the plain version."""
    args = cs.ramp_args(case, card)
    eager = mx.mix1_ramp(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before = mx.ramp_count.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        replayed = mx.mix1_ramp(*args)
    assert mx.ramp_count.captured == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert _same(replayed, eager)
    assert _same(replayed, mx._frac_ramp_reference(*args))


@pytest.mark.card
@pytest.mark.parametrize("case", [(4096, 8, False, False),
                                  (4096, 8, True, True),
                                  (255, 8, True, False)], ids=cs.ramp_label)
def test_card_vmap(card, case):
    """vmap over R = 8 streams (the rows of a crafted case): one launch, the
    same bits as 8 separate calls and as the plain version."""
    fp, fr, sl, n, m, hop = cs.ramp_args(case, card)
    dims = (0, 0, None if sl is None else 0, None, None, None)
    before = mx.ramp_count.launches
    got = torch.func.vmap(mx.mix1_ramp, in_dims=dims)(fp, fr, sl, n, m, hop)
    assert mx.ramp_count.launches == before + 1
    for r in range(fp.shape[0]):
        one = (fp[r], fr[r], None if sl is None else sl[r], n, m, hop)
        each = mx.mix1_ramp(*one)
        assert _same([g[r] for g in got], each)
        assert _same(each, mx._frac_ramp_reference(*one))


def _receiver_runs(p, iq: np.ndarray, tune_hz: float, steps: int,
                   device) -> list:
    """Every step's outputs of a graphed Receiver, the same Receiver with
    the plain ramp, and an eager one."""
    from linrad_tpu_torch.pipeline.receiver import Receiver

    def run(graphed):
        rx = Receiver(p, device=device, graphed=graphed)
        rx.tune(tune_hz)
        s = rx.geo.samples_per_step
        outs = [rx.process_block(iq[i * s:(i + 1) * s])
                for i in range(steps)]
        return rx, outs

    return [run(None), cs.plain_ramps(lambda: run(None)), run(False)]


def _fields_equal(a, b) -> None:
    import dataclasses
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.card
def test_card_flagship_receiver(card):
    """The graphed flagship Receiver tuned between two bins (12,345.6 Hz):
    8 steps bit-equal, every field, to the same Receiver on the plain ramp
    and to its eager step."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    p = flagship_params(fft1_variant="pallas")
    iq = cs.make_input(derive_geometry(p), seed=6, steps=8)
    (_rx, kern), (_, plain), (_, eager) = _receiver_runs(p, iq, cs.TUNE_HZ,
                                                         8, card)
    for a, b, c in zip(kern, plain, eager):
        _fields_equal(a, b)
        _fields_equal(a, c)


@pytest.mark.card
def test_card_eme_receiver(card):
    """The EME Receiver through the AFC's lock: its coherent structure
    hands the ramp per-frame fractions and slopes; 12 steps bit-equal,
    every field and the AFC's status, to the plain ramp's and the eager
    step's."""
    from linrad_tpu_torch import derive_geometry
    p = cs.eme_params("pallas")
    iq = cs.make_eme_input(derive_geometry(p), cs.EME_STEPS)
    runs = _receiver_runs(p, iq, cs.EME_TUNE_HZ, cs.EME_STEPS, card)
    (rx, kern), (rp, plain), (re, eager) = runs
    assert rx.graphs["coherent"].replays >= 1
    assert rx.afc.status == rp.afc.status == re.afc.status
    for a, b, c in zip(kern, plain, eager):
        _fields_equal(a, b)
        _fields_equal(a, c)


@pytest.mark.card
def test_card_ramp_one_call_a_replay(card):
    """trace.report() reads the kernel recorded once in every graph of a
    graphed flagship Receiver and once in the step graph of a FleetRunner
    of 8 streams."""
    from linrad_tpu_torch import flagship_params
    from linrad_tpu_torch.parallel import FleetRunner
    from linrad_tpu_torch.pipeline.receiver import Receiver
    from linrad_tpu_torch.utils import trace

    def captured() -> int:
        return trace.report()["counters"]["launches"]["mix1_ramp"][1]

    recorded = lambda: mx.ramp_count.captured
    c0 = captured()
    rx = Receiver(flagship_params(), device=card, recorded=recorded)
    assert rx.graphs and all(g.kernels == 1 for g in rx.graphs.values())
    assert captured() - c0 == len(rx.graphs)
    c1 = captured()
    fleet = FleetRunner(flagship_params(), 8, k_steps=2, device=card,
                        recorded=recorded)
    assert fleet.kernels_per_replay == 1 and captured() - c1 == 1


@pytest.mark.card
def test_card_refusals(card):
    """On the card: a row past the kernel's length and a fraction on the
    CPU are refused before a launch."""
    fp, fr, sl, n, m, hop = cs.ramp_args((4096, 8, True, True), card)
    before = mx.ramp_count.launches
    with pytest.raises(ValueError, match="^mix1_ramp: .*at most"):
        mx.mix1_ramp(fp, fr[:, :1], None, mx.RAMP_MAX_LEN // hop + 1, m, hop)
    with pytest.raises(ValueError, match="^mix1_ramp: .*different devices"):
        mx.mix1_ramp(fp, fr.cpu(), sl, n, m, hop)
    assert mx.ramp_count.launches == before
