"""Pieces of a seamless ring of blocks, shared by the generators, made on
the run's device (a few large calls) and handed to the host once.

A ring of L samples is replayed cyclically, so every periodic component
completes a whole number of periods in it: carriers on the ring's
frequency grid (fs / L), keying whose element divides the ring evenly,
and drifts that return to their start.  Then the wrap-around is just one
more sample boundary, and injects no impulse and unlocks no AFC.
"""

from __future__ import annotations

import math

import torch


def cycles(freq_hz: float, fs: float, length: int) -> int:
    """The whole number of cycles in the ring nearest ``freq_hz``."""
    return int(round(freq_hz * length / fs))


def index(length: int, device) -> torch.Tensor:
    return torch.arange(length, dtype=torch.int64, device=device)


def tone_phase(k: int, length: int, device) -> torch.Tensor:
    """2 pi k n / L for n in the ring, in float64, exact for any n (k n mod
    L first)."""
    n = index(length, device)
    return ((k * n) % length).to(torch.float64) * (2 * math.pi / length)


def phasor(phase: torch.Tensor, amplitude: float = 1.0) -> torch.Tensor:
    """amplitude exp(i phase) in complex64, the phase taken mod 2 pi in
    float64 first."""
    p = torch.remainder(phase, 2 * math.pi).to(torch.float32)
    return torch.polar(torch.full_like(p, amplitude), p)


def keying(element_s: float, on: int, fs: float, length: int,
           device) -> torch.Tensor:
    """On/off keying in elements of about ``element_s``, ``on`` of every 4
    keyed: the element count is a multiple of 4 that divides the ring."""
    m = 4 * max(1, int(round(length / fs / element_s / 4)))
    n = index(length, device)
    return (((n * m) // length) % 4 < on).to(torch.float32)


def impulses(gen: torch.Generator, steps: int, per_step: int, step: int,
             amplitude: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``per_step`` impulses in each step at seeded positions: (positions,
    complex amplitudes of random phase)."""
    dev = gen.device
    pos = (torch.randint(0, step, (steps, per_step), generator=gen,
                         device=dev)
           + step * index(steps, dev)[:, None]).reshape(-1)
    phase = 2 * math.pi * torch.rand(pos.numel(), generator=gen, device=dev)
    return pos, phasor(phase.to(torch.float64), amplitude)


def noise(gen: torch.Generator, length: int, channels: int,
          sigma: float) -> torch.Tensor:
    """Complex Gaussian noise, ``sigma`` on each of I and Q: (L, C)."""
    x = torch.randn((length, channels, 2), generator=gen, device=gen.device)
    return torch.view_as_complex(sigma * x)
