"""An EME radar station's own stream (Linrad's radar mode, radar.c): its
transmitter keyed in short pulses leaks into the receiver on one fft1 bin,
the receiver is muted while the transmitter is on (its noise scaled by
``mute_gain``, as ``linrad_tpu_torch/io/modeinput.py:radar_iq``), and the
moon's echo of each pulse comes back ``echo_delay_frames`` fft1 hops later,
``echo_doppler_bins`` bins off, under the noise.  The pulses' edges are
raised-cosine ramps of ``rise_s`` (as ``tx/keying.radar_pulse_train``).

The pulses start on the fft1 frame grid, every ``pulse_period_frames``
hops from a phase drawn from the seed.  Seamless (:mod:`rxbench.ring`):
the period divides the ring, the carriers lie on the ring's grid, and the
echo of the ring's last pulse wraps to its start."""

from __future__ import annotations

import math

import numpy as np
import torch

from rxbench import ring


def pulse_shape(width: int, fs: float, rise_s: float) -> tuple[np.ndarray,
                                                               int]:
    """One pulse of ``width`` samples with its edges shaped as
    ``tx/keying._shape_edges`` shapes a key: (the envelope, the offset of
    the key's first sample in it)."""
    r = max(1, int(rise_s * fs))
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(r) / r))
    kern = np.concatenate([ramp, ramp[::-1]])
    kern /= kern.sum()
    key = np.zeros(width + 4 * r)
    key[2 * r:2 * r + width] = 1.0
    return np.clip(np.convolve(key, kern, mode="same"), 0.0, 1.0), 2 * r


def pulse_starts(geo, spec: dict, gen: torch.Generator) -> np.ndarray:
    """The ring's pulses' first samples: a phase from the seed, then one a
    period."""
    hop = geo.fft1_new_points
    period = spec["pulse_period_frames"]
    length = spec["steps"] * geo.samples_per_step
    if length % (period * hop):
        raise ValueError(f"radar_echo: a pulse period of {period} hops does "
                         f"not divide a ring of {length} samples")
    phase = int(torch.randint(0, period, (1,), generator=gen,
                              device=gen.device))
    return (phase + period * np.arange(length // (period * hop))) * hop


def envelope(geo, spec: dict, starts: np.ndarray, device) -> torch.Tensor:
    """The transmitter's key over the ring, (L,) float32: each pulse's
    shaped envelope placed at its start, wrapped around the ring."""
    length = spec["steps"] * geo.samples_per_step
    shape, lead = pulse_shape(
        spec["pulse_width_frames"] * geo.fft1_new_points,
        geo.timf1_sampling_speed, spec["rise_s"])
    pos = (starts[:, None] - lead + np.arange(len(shape))[None, :]) % length
    env = torch.zeros(length, dtype=torch.float32, device=device)
    env[torch.from_numpy(pos.reshape(-1)).to(device)] = torch.from_numpy(
        np.tile(shape, len(starts)).astype(np.float32)).to(device)
    return env


def make_ring(geo, spec: dict, gen: torch.Generator,
              dial_hz: float) -> np.ndarray:
    dev = gen.device
    fs = geo.timf1_sampling_speed
    length = spec["steps"] * geo.samples_per_step
    env = envelope(geo, spec, pulse_starts(geo, spec, gen), dev)

    def carrier(fft1_bin: int, amplitude: float, phase: float
                ) -> torch.Tensor:
        k = ring.cycles(fft1_bin * fs / geo.fft1_size, fs, length)
        return ring.phasor(ring.tone_phase(k, length, dev) + phase,
                           amplitude)

    echo_phase = 2 * math.pi * float(torch.rand((), generator=gen,
                                                device=dev))
    delay = spec["echo_delay_frames"] * geo.fft1_new_points
    x = ring.noise(gen, length, geo.channels, spec["noise_sigma"])
    x *= torch.where(env > 0.01, spec["mute_gain"], 1.0)[:, None]
    x += (env * carrier(spec["tx_bin"], spec["tx_amplitude"], 0.0))[:, None]
    x += (torch.roll(env, delay) * carrier(
        spec["tx_bin"] + spec["echo_doppler_bins"], spec["echo_amplitude"],
        echo_phase))[:, None]
    return x.cpu().numpy()
