"""The radar front's per-frame statistics as the port runs them on the card:
one custom operator, ``weak/radar.py:frame_pulse_stats``, one launch of
``csrc/radar_stats.cu`` on a CUDA tensor and its plain version
``_frame_pulse_stats_reference`` (walk_steps iterations of gathers,
compares and a ``where`` over all frames) on a CPU tensor.

On the CPU these tests hold:

- the operator against the plain version, bit for bit, on
  ``chip_smoke.py``'s crafted cases (the frames phase 3b hands the card);
- a numpy model of the kernel (the row's bins split into a head before
  the first 16-byte boundary, float4s and a tail among 256 threads; each
  walk as the count of steps that pass in a row, 32 positions a ballot)
  against the walks in numpy, exactly, on every crafted case, every n,
  frame count and walk bound; the plain version's floor against the mean
  outside those walk ends in float64;
- the fake (shapes and dtypes, ``torch.library.opcheck``), the vmap rule
  (per stream on the CPU) bit-equal to separate calls, and what the
  operator refuses.

The tests marked ``card`` need a CUDA device (they skip here): the kernel
against the plain version on the card on every crafted case, peak bins
equal, floor and S/N within 1e-5 and the walk ends pinned by the floor's
float64 recomputation; vmap as one launch; a ``RadarFront`` graph replay
equal to its eager step.  This file imports no JAX and needs nothing of
``tests/conftest.py``, so that on the machine with the card ``python -m
pytest --noconftest tests/test_torch_radar_stats.py -m card`` runs them.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke as cs
from linrad_tpu_torch.weak import radar as rd

FP32 = 1e-5
THREADS = 256            # the kernel's kThreads


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want) -> bool:
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


# ---- the operator on the CPU ------------------------------------------

@pytest.mark.parametrize("name", cs.STATS_CASES)
def test_op_equals_plain_version(name):
    """On a CPU tensor the operator returns the plain version's outputs,
    bit for bit, with their dtypes."""
    for n in (256, 2050):
        power = torch.from_numpy(cs.stats_case(name, 64, n))
        for walk in cs.STATS_WALKS:
            got = rd.frame_pulse_stats(power, walk)
            assert [t.dtype for t in got] == [torch.int64, torch.float32,
                                              torch.float32]
            assert _same(got, rd._frame_pulse_stats_reference(power, walk))


@pytest.mark.parametrize("shape, walk", [((7, 100), 32), ((1, 1), 0),
                                         ((200, 2050), 64)])
def test_fake_shapes_and_dtypes(shape, walk):
    with FakeTensorMode():
        out = rd.frame_pulse_stats(torch.empty(shape), walk)
    assert [(tuple(t.shape), t.dtype) for t in out] == [
        ((shape[0],), torch.int64), ((shape[0],), torch.float32),
        ((shape[0],), torch.float32)]


@pytest.mark.parametrize("walk", [0, 32])
def test_opcheck(walk):
    power = torch.from_numpy(cs.stats_case("skirts", 8, 256))
    checks = ("test_schema", "test_faketensor")
    assert torch.library.opcheck(rd._frame_pulse_stats_op, (power, walk),
                                 test_utils=checks) == dict.fromkeys(
                                     checks, "SUCCESS")


@pytest.mark.parametrize("in_dim, walk", [(0, 32), (1, 4), (2, 33)])
def test_vmap_equals_separate_calls(in_dim, walk):
    """R = 3 streams of (64, 256) frames under torch.func.vmap, the streams
    on any axis: each output equals three separate calls, stacked."""
    streams = torch.stack([torch.from_numpy(cs.stats_case(c, 64, 256))
                           for c in ("noise", "ramps", "ties")])
    got = torch.func.vmap(rd.frame_pulse_stats, in_dims=(in_dim, None))(
        streams.movedim(0, in_dim), walk)
    each = [rd.frame_pulse_stats(s, walk) for s in streams]
    assert _same(got, [torch.stack(v) for v in zip(*each)])


@pytest.mark.parametrize("power, walk, match", [
    (torch.ones(4, 16, dtype=torch.float64), 32, "float32"),
    (torch.ones(16), 32, r"\(F, n\)"),
    (torch.ones(2, 4, 16), 32, r"\(F, n\)"),
    (torch.ones(0, 16), 32, "F >= 1"),
    (torch.ones(4, 0), 32, "1 <= n"),
    (torch.ones(4, 16), -1, "walk_steps -1"),
])
def test_check_refuses(power, walk, match):
    with pytest.raises(ValueError, match=match):
        rd.frame_pulse_stats(power, walk)


# ---- the numpy model of the kernel ------------------------------------

def _bins_of_threads(offset: int, n: int) -> list[int]:
    """Every bin the kernel's for_each_bin hands to some thread, for a row
    starting ``offset`` floats past a 16-byte boundary."""
    head = min((16 - 4 * offset) % 16 // 4, n)
    vecs = (n - head) >> 2
    out = []
    for t in range(THREADS):
        if t < head:
            out.append(t)
        for q in range(t, vecs, THREADS):
            out.extend(head + 4 * q + j for j in range(4))
        if head + 4 * vecs + t < n:
            out.append(head + 4 * vecs + t)
    return out


@pytest.mark.parametrize("offset", range(4))
def test_model_every_bin_once(offset):
    """The row's head, float4s and tail cover each bin exactly once, at
    any alignment and any n."""
    for n in list(range(1, 40)) + [255, 256, 1023, 2048, 2050, 2051, 4096]:
        assert sorted(_bins_of_threads(offset, n)) == list(range(n))


def _ballot_walk(pw: np.ndarray, k: np.ndarray, walk_steps: int, d: int
                 ) -> np.ndarray:
    """The kernel's walk: lane j of a warp tests bin k + d (steps + j) with
    the loop's compares; the trailing ones of the ballot are the steps that
    pass in a row; the next 32 while all pass and walk_steps remains."""
    f, n = pw.shape
    rows = np.arange(f)[:, None]
    lanes = np.arange(32)[None, :]
    steps = np.zeros(f, np.int64)
    live = np.full(f, walk_steps > 0)
    while live.any():
        m = k[:, None] + d * (steps[:, None] + lanes)
        m2 = m + 2 * d
        cur = pw[rows, np.clip(m, 0, n - 1)]
        passes = ((m2 >= 0) & (m2 <= n - 1)
                  & (cur > pw[rows, np.clip(m + d, 0, n - 1)])
                  & (cur > pw[rows, np.clip(m2, 0, n - 1)]))
        run = np.where(passes.all(1), 32, np.argmin(passes, 1))
        steps = np.where(live, steps + run, steps)
        live &= (run == 32) & (steps < walk_steps)
    return np.minimum(steps, walk_steps)


@pytest.mark.parametrize("name", cs.STATS_CASES)
def test_model_walks_exact(name):
    """The ballot walks end where the bounded loop does, exactly, on every
    n, frame count and walk bound; the plain version's peak bins are
    numpy's and its floor the mean outside those ends (float64, 1e-5)."""
    for n in cs.STATS_NS:
        for frames in cs.STATS_FRAMES:
            pw = cs.stats_case(name, frames, n)
            k = np.argmax(pw, axis=1)
            for walk in cs.STATS_WALKS:
                ia, ib = cs.stats_walk_ends(pw, k, walk)
                np.testing.assert_array_equal(
                    k - _ballot_walk(pw, k, walk, -1), ia)
                np.testing.assert_array_equal(
                    k + _ballot_walk(pw, k, walk, 1) + 1, ib)
                got = rd._frame_pulse_stats_reference(torch.from_numpy(pw),
                                                      walk)
                np.testing.assert_array_equal(got[0].numpy(), k)
                want = cs.stats_floor64(pw, ia, ib)
                assert cs.rel_gap(got[2].numpy(), want) <= FP32


def test_cases_reach_the_ballots_edges():
    """The crafted cases walk 31, 32, 33, 63, 64 and 65 steps (the ramps),
    reach the cap (the long skirt), and put peaks on bins 0, 1, n - 2 and
    n - 1 (edges) and on ties (the lowest bin wins)."""
    pw = cs.stats_case("ramps", 200, 2048)
    k = np.argmax(pw, axis=1)
    ia, ib = cs.stats_walk_ends(pw, k, 1000)
    assert {31, 32, 33, 63, 64, 65} <= set(k - ia) & set(ib - 1 - k)
    pw = cs.stats_case("long-skirt", 4, 256)
    ia, ib = cs.stats_walk_ends(pw, np.argmax(pw, 1), 64)
    assert list(ib - ia) == [129] * 4
    pw = cs.stats_case("edges", 4, 2050)
    assert list(np.argmax(pw, 1)) == [0, 1, 2048, 2049]
    pw = cs.stats_case("ties", 4, 256)
    k = rd._frame_pulse_stats_reference(torch.from_numpy(pw))[0].numpy()
    for f in range(4):
        assert k[f] == np.flatnonzero(pw[f] == pw[f].max())[0]
    assert k[3] == 0 and np.sum(pw[0] == pw[0].max()) == 2


# ---- on the card ------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("n", cs.STATS_NS)
@pytest.mark.parametrize("name", cs.STATS_CASES)
def test_card_stats_cases(card, name, n):
    """The kernel against the plain version on the card: peak bins equal,
    floor and S/N within 1e-5, the floor within 1e-5 of the mean outside
    the walk ends in float64, at 1, 64 and 200 frames and every bound."""
    for frames in cs.STATS_FRAMES:
        power = torch.from_numpy(cs.stats_case(name, frames, n)).to(card)
        for walk in cs.STATS_WALKS:
            got = rd.frame_pulse_stats(power, walk)
            torch.cuda.synchronize()
            cs.stats_gaps(power, walk, got,
                          rd._frame_pulse_stats_reference(power, walk))


@pytest.mark.card
def test_card_stats_vmap(card):
    """R = 3 streams: one launch, bit-equal to three calls, and to the
    plain version's bars."""
    streams = torch.stack([torch.from_numpy(cs.stats_case(c, 64, 2050))
                           for c in ("noise", "ramps", "edges")]).to(card)
    calls = rd.stats_count.launches
    got = torch.func.vmap(rd.frame_pulse_stats, in_dims=(0, None))(streams,
                                                                   33)
    assert rd.stats_count.launches == calls + 1
    each = [rd.frame_pulse_stats(s, 33) for s in streams]
    assert _same(got, [torch.stack(v) for v in zip(*each)])
    cs.stats_gaps(streams, 33, got, [torch.stack(v) for v in zip(*(
        rd._frame_pulse_stats_reference(s, 33) for s in streams))])


@pytest.mark.card
def test_card_radar_front_graph_equals_eager(card):
    """preset(RADAR)'s front replayed from its CUDA graph equals its eager
    step on every output, with one radar_stats node a replay."""
    from linrad_tpu_torch import RxMode, derive_geometry, preset
    from linrad_tpu_torch.io.modeinput import radar_iq
    p = preset(RxMode.RADAR, fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = radar_iq(geo, 3, tx_bin=cs.RADAR_TX_BIN, pulse_sep=cs.RADAR_SEP,
                  pulse_width=cs.RADAR_WIDTH, echo_delay=cs.RADAR_DELAY,
                  doppler_bins=cs.RADAR_DOPPLER)[:, None]
    captured = rd.stats_count.captured
    graphed = cs.radar_mode_fronts(p, iq, 3, card, None)
    assert graphed[0].graphed and rd.stats_count.captured == captured + 1
    eager = cs.radar_mode_fronts(p, iq, 3, card, False)
    assert not eager[0].graphed
    for a, b in zip(graphed[2], eager[2]):
        assert _same(a, b)
