"""A whole band in one wideband stream: ``stations`` keyed CW stations, one
in each ``slot_hz`` slot from ``band_lo_hz`` up, each at an offset from its
slot's centre of up to ``offset_max_hz`` drawn from the seed and rounded
to an fftx bin (so a sub-receiver tuned to it, quantised as
``MultiReceiver.tune_subch`` quantises, hears it at its dial), with an
amplitude log-uniform from ``amplitude_lo`` to ``amplitude_hi``, a phase
and a shift of its keying (``key_element_s`` elements, ``key_on_elements``
of every 4 on) drawn from the seed; ``carriers`` strong unkeyed carriers,
log-uniform from ``carrier_lo`` to ``carrier_hi``, within
``carrier_edge_hz`` of the centre and at least ``carrier_clear_hz`` from
every station; complex Gaussian noise of ``noise_sigma``; and
``impulses_per_step`` impulses of ``impulse_amplitude`` a step.

Seamless (:mod:`rxbench.ring`): every tone lies on the ring's grid and the
keying divides the ring.  :func:`layout` draws the stations and carriers
from the generator before :func:`make_ring` draws its noise, so a
generator seeded alike gives the entry the same layout."""

from __future__ import annotations

import math

import numpy as np
import torch

from rxbench import ring


def _uniform(gen: torch.Generator, n: int) -> np.ndarray:
    return torch.rand(n, generator=gen, device=gen.device,
                      dtype=torch.float64).cpu().numpy()


def layout(geo, spec: dict, gen: torch.Generator) -> dict:
    """The band's stations and carriers: ``station_hz``, ``station_amp``,
    ``station_phase``, ``key_shift`` (samples) and ``carrier_hz``,
    ``carrier_amp``, ``carrier_phase``, in the order they are drawn."""
    fs = geo.timf1_sampling_speed
    bin_hz = fs / geo.fftx_size
    k = spec["stations"]
    length = spec["steps"] * geo.samples_per_step
    centre = spec["band_lo_hz"] + spec["slot_hz"] * (np.arange(k) + 0.5)
    offset = spec["offset_max_hz"] * (2 * _uniform(gen, k) - 1)
    station_hz = np.round((centre + offset) / bin_hz) * bin_hz
    lo, hi = spec["amplitude_lo"], spec["amplitude_hi"]
    station_amp = lo * (hi / lo) ** _uniform(gen, k)
    station_phase = 2 * math.pi * _uniform(gen, k)
    key_shift = np.floor(_uniform(gen, k) * length).astype(np.int64)
    carrier_hz = []
    while len(carrier_hz) < spec["carriers"]:
        f = spec["carrier_edge_hz"] * (2 * float(_uniform(gen, 1)[0]) - 1)
        if np.abs(station_hz - f).min() >= spec["carrier_clear_hz"]:
            carrier_hz.append(ring.cycles(f, fs, length) * fs / length)
    lo, hi = spec["carrier_lo"], spec["carrier_hi"]
    m = spec["carriers"]
    return {"station_hz": station_hz, "station_amp": station_amp,
            "station_phase": station_phase, "key_shift": key_shift,
            "carrier_hz": np.array(carrier_hz),
            "carrier_amp": lo * (hi / lo) ** _uniform(gen, m),
            "carrier_phase": 2 * math.pi * _uniform(gen, m)}


def sub_receiver_hz(geo, spec: dict, gen: torch.Generator) -> np.ndarray:
    """Where the entry tunes its sub-receivers: the stations, in slot
    order."""
    return layout(geo, spec, gen)["station_hz"]


def make_ring(geo, spec: dict, gen: torch.Generator,
              dial_hz: float) -> np.ndarray:
    dev = gen.device
    fs = geo.timf1_sampling_speed
    step = geo.samples_per_step
    length = spec["steps"] * step
    lay = layout(geo, spec, gen)
    x = ring.noise(gen, length, geo.channels, spec["noise_sigma"])
    key = ring.keying(spec["key_element_s"], spec["key_on_elements"], fs,
                      length, dev)

    def tone(hz: float, amp: float, phase: float) -> torch.Tensor:
        k = ring.cycles(hz, fs, length)
        if not math.isclose(k * fs / length, hz, abs_tol=1e-6):
            raise ValueError(f"band: {hz} Hz is not on the ring's grid of "
                             f"{fs / length} Hz")
        return ring.phasor(ring.tone_phase(k, length, dev) + phase, amp)

    for hz, amp, phase, shift in zip(lay["station_hz"], lay["station_amp"],
                                     lay["station_phase"], lay["key_shift"]):
        x += (torch.roll(key, int(shift)) * tone(hz, amp, phase))[:, None]
    for hz, amp, phase in zip(lay["carrier_hz"], lay["carrier_amp"],
                              lay["carrier_phase"]):
        x += tone(hz, amp, phase)[:, None]
    if spec["impulses_per_step"]:
        pos, amp = ring.impulses(gen, spec["steps"],
                                 spec["impulses_per_step"], step,
                                 spec["impulse_amplitude"])
        x[:, 0].index_put_((pos,), amp, accumulate=True)
    return x.cpu().numpy()
