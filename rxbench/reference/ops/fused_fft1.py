"""The plain version of the port's fused first FFT: window -> FFT ->
calibration multiply -> power sum, in torch.fft (a frozen copy of
``fused_fft1_reference`` in ``linrad_tpu_torch/ops/fused_fft1.py``; the
CUDA kernel beside it is not copied)."""

from __future__ import annotations

import torch


def fused_fft1(frames: torch.Tensor, window: torch.Tensor,
               filtercorr: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """frames (B, N, C) complex64, window (N,) float32, filtercorr (N, C)
    complex64 -> (spec (B, N, C), power_sum (N, C) = sum over B of
    |spec|^2)."""
    spec = torch.fft.fft(frames * window[None, :, None], dim=1)
    spec = spec * filtercorr[None, :, :]
    return spec, (spec.abs() ** 2).sum(0)
