"""The port's matmul-DFT fft variants ("mxu", "mxu_bf16",
linrad_tpu_torch/ops/fft.py) against the JAX package's and against
numpy, mirroring tests/test_fft1.py's TestFFTVariants.

Bars: the port against JAX's "mxu" within 1e-5 of the peak (the same
fp32 products, summed in another order); the four-step transform within
2e-5 of np.fft at 4096 and 16384, as the JAX test holds it; "mxu_bf16"
within 3.5e-3 of np.fft and its round trip within 2.5e-2, as the JAX
test holds its own; the port's bf16 against JAX's bf16 within 1e-4 of
the peak (the same rounded operands, products exact in fp32, summed in
another order over up to 128 terms).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linrad_tpu.ops import fft as jfft
from linrad_tpu_torch.ops import fft as tfft


def _x(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _peak_rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [128, 256, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_matches_jax(n, inverse):
    x = _x(0, (8, n))
    t_fn = tfft.ifft if inverse else tfft.fft
    j_fn = jfft.ifft if inverse else jfft.fft
    assert _peak_rel(t_fn(torch.from_numpy(x), variant="mxu").numpy(),
                     j_fn(jnp.asarray(x), variant="mxu")) <= 1e-5
    assert _peak_rel(t_fn(torch.from_numpy(x), variant="mxu_bf16").numpy(),
                     j_fn(jnp.asarray(x), variant="mxu_bf16")) <= 1e-4


@pytest.mark.parametrize("n", [4096, 16384])
def test_four_step_large_n(n):
    """Above MXU_FFT_MAX_SIZE (0) "mxu" is Bailey's four-step split."""
    assert tfft.MXU_FFT_MAX_SIZE == jfft.MXU_FFT_MAX_SIZE == 0
    x = _x(5, (2, n))
    y = tfft.fft(torch.from_numpy(x), variant="mxu").numpy()
    ref = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(y / scale, ref / scale, atol=2e-5)
    z = tfft.ifft(torch.from_numpy(y), variant="mxu").numpy()
    np.testing.assert_allclose(z, x, rtol=2e-4, atol=2e-4)


def test_mxu_along_an_axis():
    """axis= moves the transform axis, as the JAX dispatch does."""
    x = _x(3, (3, 256, 2))
    got = tfft.fft(torch.from_numpy(x), axis=1, variant="mxu").numpy()
    ref = np.fft.fft(x, axis=1)
    assert _peak_rel(got, ref) <= 2e-5


def test_mxu_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.fft(torch.zeros((2, 96), dtype=torch.complex64), variant="mxu")
    with pytest.raises(ValueError, match="unknown"):
        tfft.fft(torch.zeros((2, 64), dtype=torch.complex64), variant="bf")


def test_mxu_bf16_error_bound():
    """The bfloat16 variant within 3.5e-3 of np.fft at N = 2048 and its
    round trip within 2.5e-2; the default stays torch.fft."""
    x = _x(2, (16, 2048))
    ref = np.fft.fft(x, axis=-1)
    y = tfft.fft(torch.from_numpy(x), variant="mxu_bf16")
    assert _peak_rel(y.numpy(), ref) < 3.5e-3
    z = tfft.ifft(y, variant="mxu_bf16").numpy()
    assert np.max(np.abs(z - x)) < 2.5e-2
    d = tfft.fft(torch.from_numpy(x)).numpy()
    assert _peak_rel(d, ref) < 1e-5


def test_ifft_roundtrip():
    x = _x(1, (4, 128))
    for v in ("xla", "mxu"):
        y = tfft.ifft(tfft.fft(torch.from_numpy(x), variant=v), variant=v)
        np.testing.assert_allclose(y.numpy(), x, rtol=1e-3, atol=1e-4)


def test_bf16_is_rounded_operands_in_fp32():
    """"mxu_bf16" is the float32 product of bf16-rounded operands, with a
    float32 result (a bf16 matmul would round the result to bf16)."""
    x = torch.from_numpy(_x(4, (4, 256)))
    assert tfft.fft(x, variant="mxu_bf16").dtype == torch.complex64
    wr, wi = tfft._dft_matrices(256, False, x.device)
    xr, xi, br, bi = (t.to(torch.bfloat16).float()
                      for t in (x.real, x.imag, wr, wi))
    want = torch.complex(xr @ br - xi @ bi, xr @ bi + xi @ br)
    assert torch.equal(tfft._matmul_fft(x, False, bf16=True), want)


def test_tf32_setting_is_restored():
    """The matmuls run with TF32 off and leave the caller's setting as
    it was (on the CPU the flag changes no number)."""
    x = torch.from_numpy(_x(6, (2, 512)))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = tfft.fft(x, variant="mxu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = False
        off = tfft.fft(x, variant="mxu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(on, off)
