"""FFT variant dispatch (port of linrad_tpu/ops/fft.py).

``"xla"`` (and the default, None) is ``torch.fft``, which is cuFFT on the
card.  ``"mxu"`` and ``"mxu_bf16"`` are the JAX package's DFT-as-matmul
lowerings, written there for the TPU's matrix unit: the DFT as four real
matrix products, and above ``MXU_FFT_MAX_SIZE`` (0: always) Bailey's
four-step split N = N1 N2 into two batched matmul DFTs and a twiddle.
Here they are plain ``torch.matmul`` of float32 tensors, in full float32
whatever the caller's TF32 setting (see :func:`_full_fp32`).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# Size at or below which variant=None selects the matmul DFT, as in the
# JAX package (0: torch.fft everywhere; "mxu"/"mxu_bf16" are explicit).
MXU_FFT_MAX_SIZE = 0


def fft(x: torch.Tensor, axis: int = -1,
        variant: str | None = None) -> torch.Tensor:
    """Forward FFT along ``axis``."""
    return _dispatch(x, axis, inverse=False, variant=variant)


def ifft(x: torch.Tensor, axis: int = -1,
         variant: str | None = None) -> torch.Tensor:
    """Inverse FFT along ``axis`` (1/N normalised)."""
    return _dispatch(x, axis, inverse=True, variant=variant)


@functools.lru_cache(maxsize=32)
def _dft_matrices(n: int, inverse: bool, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts of the (n, n) DFT matrix, float32 (1/n in
    the inverse), made once per device: a copy from the host inside a
    step would wait for the host and could not be captured into a CUDA
    graph."""
    sign = 2.0 if inverse else -2.0
    k = np.arange(n)
    ang = sign * np.pi * np.outer(k, k) / n
    scale = 1.0 / n if inverse else 1.0
    return (torch.from_numpy((np.cos(ang) * scale).astype(np.float32)
                             ).to(device),
            torch.from_numpy((np.sin(ang) * scale).astype(np.float32)
                             ).to(device))


@functools.lru_cache(maxsize=16)
def _twiddle(n1: int, n2: int, inverse: bool,
             device: torch.device) -> torch.Tensor:
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
    return torch.from_numpy(np.exp(1j * ang).astype(np.complex64)).to(device)


@contextlib.contextmanager
def _full_fp32():
    """float32 matrix products in full float32 on the card: TF32 off for
    cuBLAS while inside, the caller's setting restored after.  The JAX
    package pins Precision.HIGHEST per call for the same reason: reduced
    precision in these products gave 0.62 relative audio error through
    the FFT cascade."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 and held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _matmul_fft(x: torch.Tensor, inverse: bool,
                bf16: bool = False) -> torch.Tensor:
    """Batched DFT along the last axis as four real matrix products.

    ``bf16`` rounds both operands to bfloat16 and multiplies them in
    float32 with a float32 result: the JAX variant's bf16 operands with
    ``preferred_element_type=float32``.  A product of two bfloat16 values
    is exact in float32, so only the summation order can differ from it.
    (``torch.matmul`` of two bfloat16 tensors would round the result to
    bfloat16, another function.)"""
    wr, wi = _dft_matrices(x.shape[-1], inverse, x.device)
    xr, xi = x.real.to(torch.float32), x.imag.to(torch.float32)
    if bf16:
        wr, wi, xr, xi = _bf16(wr), _bf16(wi), _bf16(xr), _bf16(xi)
    with _full_fp32():
        yr = torch.matmul(xr, wr) - torch.matmul(xi, wi)
        yi = torch.matmul(xr, wi) + torch.matmul(xi, wr)
    return torch.complex(yr, yi)


def _four_step_fft(x: torch.Tensor, inverse: bool,
                   bf16: bool = False) -> torch.Tensor:
    """Bailey's four-step DFT, N = N1 N2 as two batched matmul DFTs.
    With n = n1 N2 + n2 and k = k1 + N1 k2:

        X[k1 + N1 k2] = sum_{n2} W_{N2}^{n2 k2} W_N^{n2 k1}
                          sum_{n1} x[n1 N2 + n2] W_{N1}^{n1 k1}

    The inverse's two stages apply 1/N1 and 1/N2; the twiddle stays
    unscaled."""
    n = x.shape[-1]
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    lead = x.shape[:-1]
    a = x.reshape(lead + (n1, n2))                            # a[n1, n2]
    y = _matmul_fft(a.transpose(-1, -2), inverse, bf16)       # y[n2, k1]
    y = y * _twiddle(n2, n1, inverse, x.device)
    z = _matmul_fft(y.transpose(-1, -2), inverse, bf16)       # z[k1, k2]
    return z.transpose(-1, -2).reshape(lead + (n,))           # X[k1+N1 k2]


def _dispatch(x, axis, inverse, variant):
    n = x.shape[axis]
    if variant is None:
        variant = "mxu" if n <= MXU_FFT_MAX_SIZE else "xla"
    if variant == "xla":
        return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=axis)
    if variant not in ("mxu", "mxu_bf16"):
        raise ValueError(f"unknown fft variant {variant!r}")
    if n & (n - 1):
        raise ValueError(f"mxu variant requires power-of-two size, got {n}")
    x = torch.movedim(x, axis, -1)
    bf16 = variant == "mxu_bf16"
    if n <= MXU_FFT_MAX_SIZE:
        y = _matmul_fft(x, inverse, bf16=bf16)
    else:
        y = _four_step_fft(x, inverse, bf16=bf16)
    return torch.movedim(y, -1, axis)
