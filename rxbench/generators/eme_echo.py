"""An EME station's X/Y stream: a keyed CW echo a few Hz above the dial,
polarized across the two channels and drifting as f0 + A sin(2 pi t / T)
with T the ring's length (peak drift ``drift_peak_hz_per_s``, the port's
smoke test's 0.05 Hz/s); complex Gaussian noise; a strong carrier (the
selective limiter's strong bins) and impulses (the blankers' work), each
with its own gain on the two channels.  Seamless: see :mod:`rxbench.ring`;
f0 lies on the ring's grid and the drift returns to its start."""

from __future__ import annotations

import math

import numpy as np
import torch

from rxbench import ring


def make_ring(geo, spec: dict, gen: torch.Generator,
              dial_hz: float) -> np.ndarray:
    dev = gen.device
    fs = geo.timf1_sampling_speed
    step = geo.samples_per_step
    length = spec["steps"] * step
    period_s = length / fs
    k0 = ring.cycles(dial_hz + spec["echo_offset_hz"], fs, length)
    # f0 + A sin(2 pi t / T): A 2 pi / T is the peak drift rate
    amp_hz = spec["drift_peak_hz_per_s"] * period_s / (2 * math.pi)
    n = ring.index(length, dev).to(torch.float64)
    phase = ring.tone_phase(k0, length, dev) - amp_hz * period_s * torch.cos(
        (2 * math.pi / length) * n)
    key = ring.keying(spec["key_element_s"], spec["key_on_elements"], fs,
                      length, dev)

    def gains(values):
        return torch.tensor([complex(*v) if isinstance(v, list) else v
                             for v in values], dtype=torch.complex64,
                            device=dev)

    x = ring.noise(gen, length, geo.channels, spec["noise_sigma"])
    x += (key * ring.phasor(phase, spec["echo_amplitude"]))[:, None] \
        * gains(spec["pol"])[None, :]
    kc = ring.cycles(spec["carrier_hz"], fs, length)
    x += ring.phasor(ring.tone_phase(kc, length, dev)
                     + spec["carrier_phase"],
                     spec["carrier_amplitude"])[:, None] \
        * gains(spec["carrier_gains"])[None, :]
    pos, amp = ring.impulses(gen, spec["steps"], spec["impulses_per_step"],
                             step, spec["impulse_amplitude"])
    x.index_put_((pos,), amp[:, None] * gains(spec["impulse_gains"])[None, :],
                 accumulate=True)
    return x.cpu().numpy()
