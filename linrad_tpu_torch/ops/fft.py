"""FFT variant dispatch (port of linrad_tpu/ops/fft.py).

``"xla"`` (and the default, None) is ``torch.fft``, which is cuFFT on the
card.  The JAX package's ``"mxu"``/``"mxu_bf16"`` variants are
DFT-as-matmul lowerings for the TPU's matrix unit; whether the port needs
them is still open (ROADMAP queue 2 item 2), so they raise.
"""

from __future__ import annotations

import torch

UNPORTED_VARIANTS = ("mxu", "mxu_bf16")


def fft(x: torch.Tensor, axis: int = -1,
        variant: str | None = None) -> torch.Tensor:
    """Forward FFT along ``axis``."""
    return _dispatch(x, axis, inverse=False, variant=variant)


def ifft(x: torch.Tensor, axis: int = -1,
         variant: str | None = None) -> torch.Tensor:
    """Inverse FFT along ``axis`` (1/N normalised)."""
    return _dispatch(x, axis, inverse=True, variant=variant)


def _dispatch(x, axis, inverse, variant):
    if variant in (None, "xla"):
        return (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=axis)
    if variant in UNPORTED_VARIANTS:
        raise NotImplementedError(
            f"fft variant {variant!r} (the TPU matmul-DFT lowering) is not "
            f"ported; see ROADMAP queue 2 item 2")
    raise ValueError(f"unknown fft variant {variant!r}")
