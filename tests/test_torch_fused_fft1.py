"""The port's fused fft1 (linrad_tpu_torch.ops.fused_fft1) against the JAX
Pallas kernel, run in interpret mode as tests/test_pallas.py runs it, and
against numpy.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card by
chip_smoke.py.  Tolerance: max|a-b| <= 1e-4 * max|b| on spectrum and power
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
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops.fused_fft1 import fused_fft1, fused_fft1_reference

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


def test_cpu_path_is_the_plain_version_and_not_counted():
    frames, window, fc = _inputs(8, 256, 2)
    args = (torch.from_numpy(frames), torch.from_numpy(window),
            torch.from_numpy(fc))
    before = fused_fft1.launches
    spec, psum = fused_fft1(*args)
    r_spec, r_psum = fused_fft1_reference(*args)
    assert torch.equal(spec, r_spec) and torch.equal(psum, r_psum)
    assert fused_fft1.launches == before


def test_rejects_bad_dtype_and_device():
    frames, window, fc = _inputs(4, 128, 1)
    with pytest.raises(ValueError):
        fused_fft1(torch.from_numpy(frames).to(torch.complex128),
                   torch.from_numpy(window), torch.from_numpy(fc))
    with pytest.raises(ValueError):
        fused_fft1(torch.from_numpy(frames), torch.from_numpy(window)[:64],
                   torch.from_numpy(fc))
    meta = torch.empty((4, 128, 1), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        fused_fft1(meta, torch.empty(128, device="meta"),
                   torch.empty((128, 1), dtype=torch.complex64,
                               device="meta"))


def _fft1_geo():
    p = RxParams(rx_ad_speed=96_000, first_fft_bandwidth=200.0,
                 target_fft1_frames_per_step=16)
    geo = derive_geometry(p)
    assert geo.fft1_size <= 1024
    return geo


@pytest.mark.parametrize("variant", ["pallas", "xla"])
def test_fft1_step_matches_jax(variant):
    """Port fft1_step against JAX fft1_step with the same variant, two
    steps so the tail carry is exercised."""
    geo = _fft1_geo()
    rng = np.random.default_rng(3)
    fc = (rng.normal(size=geo.fft1_size)
          + 1j * rng.normal(size=geo.fft1_size))
    j_tab = jfft1.FFT1Tables.create(geo, filtercorr=fc)
    t_tab = tfft1.FFT1Tables.create(geo, "cpu", filtercorr=fc)
    j_st = jfft1.FFT1State.create(geo)
    t_st = tfft1.FFT1State.create(geo, "cpu")
    for _ in range(2):
        block = (rng.normal(size=(geo.samples_per_step, 1))
                 + 1j * rng.normal(size=(geo.samples_per_step, 1))
                 ).astype(np.complex64)
        j_st, j_spec, j_pow = jfft1.fft1_step(geo, j_tab, j_st,
                                              jnp.asarray(block), 8,
                                              variant=variant)
        t_st, t_spec, t_pow = tfft1.fft1_step(geo, t_tab, t_st,
                                              torch.from_numpy(block), 8,
                                              variant=variant)
        assert _rel(t_spec.numpy(), j_spec) <= RTOL
        assert _rel(t_pow.numpy(), j_pow) <= RTOL
        assert _rel(t_st.sumsq_avg.numpy(), j_st.sumsq_avg) <= RTOL
        np.testing.assert_array_equal(t_st.tail.numpy(), np.asarray(j_st.tail))


def test_fft1_step_variant_parity():
    """fft1_step(variant='pallas') == fft1_step(variant='xla') in the port
    (mirrors test_pallas.py:test_fft1_step_variant_parity)."""
    geo = _fft1_geo()
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
