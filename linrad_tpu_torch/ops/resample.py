"""Audio-rate conversion — the rx_output resampler (port of
linrad_tpu/ops/resample.py; reference ``rx_output`` rxout.c:266, 4-point
interpolation with precomputed weights rxout.c:1111-1148).

With file input and output there is no clock drift, so the ratio is an
exact rational fs_out/fs_in = p/q and every step gives a fixed number of
output samples.  ``taps=4`` interpolates with a Catmull-Rom cubic, as the
reference's 4-tap scheme does; ``taps > 4`` selects a Blackman-Harris
windowed sinc, which interpolates and rejects images in one contraction
(the reference follows its interpolator with an anti-image IIR,
rxout.c:1165-1210).  The fractional positions repeat with period p, so
the index and weight tables are built once, in numpy float64 exactly as
the JAX package builds them, and a step is one gather and one
(S_out, taps) x (taps,) weighted sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def _catmull_rom(frac: np.ndarray) -> np.ndarray:
    """4-tap interpolation weights for fractional offsets (S,) -> (S, 4)."""
    t = frac
    w0 = -0.5 * t ** 3 + t ** 2 - 0.5 * t
    w1 = 1.5 * t ** 3 - 2.5 * t ** 2 + 1.0
    w2 = -1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t
    w3 = 0.5 * t ** 3 - 0.5 * t ** 2
    return np.stack([w0, w1, w2, w3], axis=-1)


@dataclass
class ResamplerState:
    history: torch.Tensor  # (taps-1, C) — carried input tail

    @classmethod
    def create(cls, channels: int, device, dtype=torch.float32,
               taps: int = 4) -> "ResamplerState":
        return cls(history=torch.zeros((taps - 1, channels), dtype=dtype,
                                       device=device))


class Resampler:
    """Rational-ratio streaming resampler with fixed output shapes."""

    def __init__(self, fs_in: float, fs_out: float, block_in: int,
                 channels: int, device, dtype=torch.float32, taps: int = 4,
                 cutoff: float = 0.92):
        # express the ratio as an exact rational p/q
        ratio = fs_out / fs_in
        q = 1
        while (abs(ratio * q - round(ratio * q)) > 1e-9 and q < 1 << 20):
            q += 1
        p = int(round(ratio * q))
        g = math.gcd(p, q)
        p, q = p // g, q // g
        if block_in * p % q != 0:
            raise ValueError(
                f"block of {block_in} input samples maps to a non-integer "
                f"output count at ratio {p}/{q}; pick fs_out so that "
                f"block_in*fs_out/fs_in is an integer")
        self.p, self.q = p, q
        self.block_in = block_in
        self.block_out = block_in * p // q
        self.channels = channels
        self.taps = taps
        self.device = torch.device(device)
        self.dtype = dtype
        # output i nominally sits at input position i*q/p; the stream is
        # delayed so the future taps always come from the carried history
        # (causal streaming, rxout.c:266-500)
        pos = np.arange(self.block_out) * q / p
        base = np.floor(pos).astype(np.int64)
        frac = pos - base
        idx = base[:, None] + np.arange(taps)[None, :]
        if taps == 4:
            w = _catmull_rom(frac)
        else:
            # windowed sinc: tap j in the buffer is input sample
            # base+j-(taps-1); the output is taken at time pos-D with
            # D = taps//2, so the kernel argument for tap j is
            # (pos-D) - (base+j-(taps-1)) = frac + (taps-1-D) - j
            d = taps // 2
            arg = frac[:, None] + (taps - 1 - d) - np.arange(taps)[None]
            cut = cutoff * min(1.0, p / q)   # anti-image/anti-alias
            k = cut * np.sinc(cut * arg)
            # Blackman-Harris window over the tap span
            u = (arg + d) / (taps - 1)       # 0..1 across the kernel
            u = np.clip(u, 0.0, 1.0)
            win = (0.35875 - 0.48829 * np.cos(2 * np.pi * u)
                   + 0.14128 * np.cos(4 * np.pi * u)
                   - 0.01168 * np.cos(6 * np.pi * u))
            w = k * win
            w /= w.sum(axis=1, keepdims=True)   # exact DC gain
        self._idx = torch.from_numpy(idx).to(self.device)
        self._w = torch.from_numpy(w.astype(np.float32)).to(self.device)

    def init_state(self) -> ResamplerState:
        return ResamplerState.create(self.channels, self.device, self.dtype,
                                     self.taps)

    def __call__(self, state: ResamplerState, x: torch.Tensor
                 ) -> tuple[ResamplerState, torch.Tensor]:
        """x: (block_in, C) -> (block_out, C)."""
        buf = torch.cat([state.history, x], dim=0)
        taps = buf[self._idx]                       # (S_out, T, C)
        out = (taps * self._w[:, :, None]).sum(1)
        return (ResamplerState(history=buf[buf.shape[0] - (self.taps - 1):]),
                out.to(x.dtype))
