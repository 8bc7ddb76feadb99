"""The flagship's stream: a weak keyed CW tone at the dial, complex
Gaussian noise, a strong carrier and impulse noise (as the port's smoke
test's ``make_input``, made seamless: see :mod:`rxbench.ring`).  A spec
with ``carrier_amplitude`` 0 and ``impulses_per_step`` 0 leaves out the
carrier and the impulses."""

from __future__ import annotations

import numpy as np
import torch

from rxbench import ring


def make_ring(geo, spec: dict, gen: torch.Generator,
              dial_hz: float) -> np.ndarray:
    dev = gen.device
    fs = geo.timf1_sampling_speed
    step = geo.samples_per_step
    length = spec["steps"] * step
    key = ring.keying(spec["key_element_s"], spec["key_on_elements"], fs,
                      length, dev)
    x = ring.noise(gen, length, geo.channels, spec["noise_sigma"])
    x += (key * ring.phasor(ring.tone_phase(
        ring.cycles(dial_hz, fs, length), length, dev),
        spec["tone_amplitude"]))[:, None]
    if spec["carrier_amplitude"]:
        k = ring.cycles(spec["carrier_hz"], fs, length)
        x += ring.phasor(ring.tone_phase(k, length, dev)
                         + spec["carrier_phase"],
                         spec["carrier_amplitude"])[:, None]
    if spec["impulses_per_step"]:
        pos, amp = ring.impulses(gen, spec["steps"],
                                 spec["impulses_per_step"], step,
                                 spec["impulse_amplitude"])
        x[:, 0].index_put_((pos,), amp, accumulate=True)
    return x.cpu().numpy()
