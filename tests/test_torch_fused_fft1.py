"""The port's fused fft1 (linrad_tpu_torch.ops.fused_fft1) against the JAX
Pallas kernel, run in interpret mode as tests/test_pallas.py runs it, and
against numpy.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card by
chip_smoke.py.  What the kernel leaves to Python is held here: the
factorisation of N into radix-8 and radix-4 passes (with the passes'
index arithmetic run in numpy), the launch plan for every N and channel
count against the card's limits, and the byte count behind the kernel's
bound.  Tolerance: max|a-b| <= 1e-4 * max|b| on spectrum and power
sum — both sides are fp32 FFTs or DFTs, so this is far tighter than
test_pallas.py's 2e-3/2e-2.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linrad_tpu import RxParams, derive_geometry
from linrad_tpu.ops import fft1 as jfft1
from linrad_tpu.ops.pallas_fft import fused_fft1 as jax_fused_fft1
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import fused_fft1 as ff
from linrad_tpu_torch.ops.fused_fft1 import fused_fft1

RTOL = 1e-4


def _rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _inputs(b, n, c, seed=7):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, n, c))
              + 1j * rng.normal(size=(b, n, c))).astype(np.complex64)
    window = (np.sin(np.pi * (np.arange(n) + 0.5) / n) ** 2).astype(
        np.float32)
    fc = ((rng.normal(size=(n, c)) + 1j * rng.normal(size=(n, c)))
          * 0.1).astype(np.complex64)
    return frames, window, fc


SHAPES = [(16, 256, 1), (40, 512, 2), (128, 1024, 1), (3, 128, 1),
          (64, 2048, 1)]


@pytest.mark.parametrize("b,n,c", SHAPES)
def test_matches_jax_pallas_and_numpy(b, n, c):
    frames, window, fc = _inputs(b, n, c)
    spec, psum = fused_fft1(torch.from_numpy(frames),
                            torch.from_numpy(window), torch.from_numpy(fc))
    assert spec.shape == (b, n, c) and spec.dtype == torch.complex64
    assert psum.shape == (n, c) and psum.dtype == torch.float32
    j_spec, j_psum = jax_fused_fft1(jnp.asarray(frames), jnp.asarray(window),
                                    jnp.asarray(fc), interpret=True)
    assert _rel(spec.numpy(), j_spec) <= RTOL
    assert _rel(psum.numpy(), j_psum) <= RTOL
    ref = np.fft.fft(frames.astype(np.complex128) * window[None, :, None],
                     axis=1) * fc[None]
    assert _rel(spec.numpy(), ref) <= RTOL
    assert _rel(psum.numpy(), np.sum(np.abs(ref) ** 2, axis=0)) <= RTOL


@pytest.mark.parametrize("n", [96, 384, 64, 8192])
def test_rejects_unsupported_size(n):
    """Powers of two from 128 to 4096 only; 384 (a non-power-of-two
    multiple of 128, which no geometry produces) is refused too."""
    x = torch.zeros((4, n, 1), dtype=torch.complex64)
    with pytest.raises(ValueError, match="unsupported transform size"):
        fused_fft1(x, torch.zeros(n), torch.zeros((n, 1),
                                                  dtype=torch.complex64))


def test_rejects_bad_dtype_and_device():
    frames, window, fc = _inputs(4, 128, 1)
    with pytest.raises(ValueError):
        fused_fft1(torch.from_numpy(frames).to(torch.complex128),
                   torch.from_numpy(window), torch.from_numpy(fc))
    with pytest.raises(ValueError):
        fused_fft1(torch.from_numpy(frames), torch.from_numpy(window)[:64],
                   torch.from_numpy(fc))
    # an unsupported device is refused by the operator's dispatch
    # (tests/test_torch_hand_kernels.py); tensors on two devices here
    with pytest.raises(ValueError, match="different devices"):
        fused_fft1(torch.from_numpy(frames), torch.empty(128, device="meta"),
                   torch.from_numpy(fc))


def _fft1_geo():
    """(the JAX package's Geometry, the port's) for one small fft1."""
    p = RxParams(rx_ad_speed=96_000, first_fft_bandwidth=200.0,
                 target_fft1_frames_per_step=16)
    geo = derive_geometry(p)
    assert geo.fft1_size <= 1024
    return geo, t_derive_geometry(convert.params_from_jax(p))


@pytest.mark.parametrize("variant", ["pallas", "xla"])
def test_fft1_step_matches_jax(variant):
    """Port fft1_step against JAX fft1_step with the same variant, two
    steps so the tail carry is exercised."""
    geo, tgeo = _fft1_geo()
    rng = np.random.default_rng(3)
    fc = (rng.normal(size=geo.fft1_size)
          + 1j * rng.normal(size=geo.fft1_size))
    j_tab = jfft1.FFT1Tables.create(geo, filtercorr=fc)
    t_tab = tfft1.FFT1Tables.create(tgeo, "cpu", filtercorr=fc)
    j_st = jfft1.FFT1State.create(geo)
    t_st = tfft1.FFT1State.create(tgeo, "cpu")
    for _ in range(2):
        block = (rng.normal(size=(geo.samples_per_step, 1))
                 + 1j * rng.normal(size=(geo.samples_per_step, 1))
                 ).astype(np.complex64)
        j_st, j_spec, j_pow = jfft1.fft1_step(geo, j_tab, j_st,
                                              jnp.asarray(block), 8,
                                              variant=variant)
        t_st, t_spec, t_pow = tfft1.fft1_step(tgeo, t_tab, t_st,
                                              torch.from_numpy(block), 8,
                                              variant=variant)
        assert _rel(t_spec.numpy(), j_spec) <= RTOL
        assert _rel(t_pow.numpy(), j_pow) <= RTOL
        assert _rel(t_st.sumsq_avg.numpy(), j_st.sumsq_avg) <= RTOL
        np.testing.assert_array_equal(t_st.tail.numpy(), np.asarray(j_st.tail))


def test_fft1_step_variant_parity():
    """fft1_step(variant='pallas') == fft1_step(variant='xla') in the port
    (mirrors test_pallas.py:test_fft1_step_variant_parity)."""
    _, geo = _fft1_geo()
    rng = np.random.default_rng(3)
    tab = tfft1.FFT1Tables.create(
        geo, "cpu", filtercorr=(rng.normal(size=geo.fft1_size)
                                + 1j * rng.normal(size=geo.fft1_size)))
    block = torch.from_numpy((rng.normal(size=(geo.samples_per_step, 1))
                              + 1j * rng.normal(size=(geo.samples_per_step,
                                                      1))
                              ).astype(np.complex64))
    s0 = tfft1.FFT1State.create(geo, "cpu")
    s_a, spec_a, pow_a = tfft1.fft1_step(geo, tab, s0, block, 8, "xla")
    s_b, spec_b, pow_b = tfft1.fft1_step(geo, tab, s0, block, 8, "pallas")
    assert _rel(spec_a.numpy(), spec_b.numpy()) <= RTOL
    assert _rel(pow_a.numpy(), pow_b.numpy()) <= RTOL
    assert _rel(s_a.sumsq_avg.numpy(), s_b.sumsq_avg.numpy()) <= RTOL
    assert torch.equal(s_a.tail, s_b.tail)


# ---- what the CUDA kernel leaves to Python -----------------------------

SIZES = [128, 256, 512, 1024, 2048, 4096]


def _stockham(x: np.ndarray, radices, tables: np.ndarray) -> np.ndarray:
    """The kernel's passes in numpy (complex128): butterfly j of a pass of
    radix r reads points j + i n/r, multiplies point i by the pass's
    table entry [k (r - 1) + i - 1] = exp(-2 pi i i k / (p r)) with
    k = j mod p (the first pass, p = 1, multiplies nothing), takes the
    r-point DFT and writes to (j - k) r + k + i p; p is the product of the
    radices before, and the passes' tables follow one another."""
    n = x.size
    src, p, off = x.astype(np.complex128), 1, 0
    for s, r in enumerate(radices):
        q = n // r
        j = np.arange(q)
        k = j % p
        i = np.arange(r)
        a = src[j[None, :] + i[:, None] * q]
        if s > 0:
            a[1:] *= tables[off + k[None, :] * (r - 1) + i[1:, None] - 1]
            off += p * (r - 1)
        y = np.exp(-2j * np.pi * np.outer(i, i) / r) @ a
        dst = np.empty_like(src)
        dst[((j - k) * r + k)[None, :] + i[:, None] * p] = y
        src, p = dst, p * r
    assert off < n and not tables[off:].any()
    return src


@pytest.mark.parametrize("n", SIZES)
def test_radix_plan(n):
    radices = ff.radix_plan(n)
    assert int(np.prod(radices)) == n
    assert set(radices) <= {4, 8}
    assert list(radices) == sorted(radices, reverse=True)
    assert radices.count(4) <= 2
    log8 = -(-(n.bit_length() - 1) // 3)
    assert len(radices) <= log8 + 1
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    tables = ff.twiddle_tables(n)
    assert tables.shape == (n,) and tables.dtype == np.complex64
    assert _rel(_stockham(x, radices, tables), np.fft.fft(x)) <= 1e-6


@pytest.mark.parametrize("n", [64, 96, 384, 8192])
def test_radix_plan_rejects(n):
    with pytest.raises(ValueError, match="unsupported transform size"):
        ff.radix_plan(n)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_launch_plan_within_the_cards_limits(n, c):
    for b in (1, 3, 40, 64, 132, 1000, 2048, 100_000):
        plan = ff.launch_plan(b, n, c)
        gx, gy = plan["grid"]
        fpb = plan["frames_per_block"]
        assert plan["ch"] == c and gy == 1
        assert plan["smem_bytes"] == 25 * n * c <= ff.MAX_SMEM_BYTES
        assert 32 <= plan["threads"] <= ff.MAX_THREADS
        assert plan["threads"] >= n * c // 8       # one radix-8 item each
        assert plan["threads"] % 32 == 0
        assert gx % ff.CLUSTER == 0 and plan["clusters"] == gx // ff.CLUSTER
        assert gx * fpb >= b                       # every frame is taken
        assert (gx - ff.CLUSTER) * fpb < b         # no cluster is idle
        per_sm = plan["blocks_per_sm"]
        assert per_sm * (plan["smem_bytes"] + 1024) <= ff.SMEM_PER_SM
        assert per_sm * plan["threads"] <= 2048
        assert 1 <= per_sm <= ff.MAX_BLOCKS_PER_SM
        # the whole grid is resident at once, and a block takes a second
        # frame only when the card is full
        assert gx <= max(ff.CLUSTER, ff.H100_SMS * per_sm)
        if fpb > 1:
            assert gx * 2 > ff.H100_SMS * per_sm - ff.CLUSTER
        assert (n * c) % ff.CLUSTER == 0           # an eighth of a row each
        assert plan["radices"] == ff.radix_plan(n)


@pytest.mark.parametrize("shape,expect", [
    ((64, 2048, 1), dict(ch=1, threads=256, smem_bytes=51_200,
                         frames_per_block=1, grid=(64, 1), clusters=8)),
    ((64, 4096, 2), dict(ch=2, threads=1024, smem_bytes=204_800,
                         frames_per_block=1, grid=(64, 1), clusters=8)),
    ((2048, 2048, 1), dict(ch=1, threads=256, smem_bytes=51_200,
                           frames_per_block=4, grid=(512, 1), clusters=64)),
    ((3, 128, 1), dict(ch=1, threads=32, smem_bytes=3_200,
                       frames_per_block=1, grid=(8, 1), clusters=1)),
    ((40, 512, 2), dict(ch=2, threads=128, smem_bytes=25_600,
                        frames_per_block=1, grid=(40, 1), clusters=5)),
    # more than two channels: pairs, or single channels, along grid y
    ((16, 1024, 4), dict(ch=2, threads=256, grid=(16, 2), clusters=2)),
    ((16, 1024, 3), dict(ch=1, threads=128, grid=(16, 3), clusters=2)),
])
def test_launch_plan_at_known_shapes(shape, expect):
    plan = ff.launch_plan(*shape)
    assert {k: plan[k] for k in expect} == expect


def test_launch_plan_rejects():
    with pytest.raises(ValueError):
        ff.launch_plan(4, 100, 1)
    with pytest.raises(ValueError):
        ff.launch_plan(0, 128, 1)
    with pytest.raises(ValueError):
        ff.launch_plan(4, 128, 0)


@pytest.mark.parametrize("shape,nbytes,bound_us", [
    ((64, 2048, 1), 2_129_920, 0.64),
    ((64, 4096, 2), 8_503_296, 2.54),
    ((2048, 2048, 1), 67_141_632, 20.0),
])
def test_necessary_bytes_and_bound(shape, nbytes, bound_us):
    """Each input byte read once, each output byte written once, over
    3.35 TB/s; the arithmetic at 67 TFLOP/s stays well under it."""
    assert ff.necessary_bytes(*shape) == nbytes
    by_bytes = nbytes / 3.35e12 * 1e6
    assert abs(by_bytes - bound_us) <= 0.05
    b, n, c = shape
    ops = ff.operations(*shape)
    assert ops >= b * c * 5 * n * (n.bit_length() - 1)
    assert 4 * ops / 67e12 * 1e6 < by_bytes
