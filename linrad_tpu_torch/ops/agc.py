"""AGC — peak tracking with attack / release / hang (port of
linrad_tpu/ops/agc.py, reference mix2.c:1517-1620, factors
baseb_graph.c:435-437).

Release: env[t] = max(|x[t]|, r * env[t-1]) (decay_max); hang: a causal
sliding-window max before it; attack: a one-pole smoothing of the gain,
capped by the instantaneous safe gain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.scanops import decay_max, one_pole, sliding_max


@dataclass
class AGCState:
    env: torch.Tensor   # (C,) float32 — release-tracked envelope
    gain: torch.Tensor  # (C,) float32 — smoothed gain

    @classmethod
    def create(cls, channels: int, device) -> "AGCState":
        return cls(env=torch.full((channels,), 1e-6, dtype=torch.float32,
                                  device=device),
                   gain=torch.ones((channels,), dtype=torch.float32,
                                   device=device))


def agc(state: AGCState, x: torch.Tensor, fs: float, attack_ms: float,
        release_ms: float, hang_ms: float = 0.0, target: float = 1.0
        ) -> tuple[AGCState, torch.Tensor, torch.Tensor]:
    """Apply AGC to audio (S, C) float32.

    Returns (new_state, audio_out, gain_series)."""
    mag = x.abs().to(torch.float32)
    if hang_ms > 0:
        mag = sliding_max(mag, max(1, int(fs * hang_ms * 1e-3)))
    release = float(np.float32(0.5 ** (1e3 / (fs * max(release_ms, 1e-3)))))
    env, env_last = decay_max(torch.clamp(mag, min=1e-9), release,
                              state.env)
    raw_gain = target / env
    attack = float(np.float32(0.5 ** (1e3 / (fs * max(attack_ms, 1e-3)))))
    gain, gain_last = one_pole(raw_gain, attack, state.gain)
    # never exceed the instantaneous safe gain (fast attack on peaks)
    gain = torch.minimum(gain, raw_gain * 1.412)
    return AGCState(env=env_last, gain=gain_last), x * gain.to(x.dtype), gain
