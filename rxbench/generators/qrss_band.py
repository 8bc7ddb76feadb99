"""A QRSS window as a grabber hears it: slow CW beacons, the station's own
birdies and noise.

- **The target beacon**, the one the AFC holds: ``target_offset_hz`` above
  the dial, amplitude ``target_amplitude``, keyed in a seeded message of
  QRSS elements of about ``element_s`` (a dot one element on, a dash
  three, one element off after each, sometimes two more between letters),
  drifting sinusoidally with a peak rate of ``target_drift_hz_per_s``.
- **Other beacons**, ``beacons`` of them, each keyed in its own message,
  at seeded offsets from ``beacon_lo_hz`` to ``beacon_hi_hz`` above the
  dial and at least ``beacon_spacing_hz`` apart, amplitudes log-uniform
  from ``beacon_amp_lo`` to ``beacon_amp_hi``, each drifting at a seeded
  peak rate of up to ``beacon_drift_hz_per_s``.
- **Birdies**, steady carriers log-uniform from ``birdie_amp_lo`` to
  ``birdie_amp_hi``: ``birdies_near`` of them ``near_lo_hz`` to
  ``near_hi_hz`` from the dial on either side (inside mix1's window and
  the filter, outside the AFC's search), ``birdies_far`` anywhere within
  ``far_edge_hz`` of zero and farther than ``near_hi_hz`` + 100 Hz from
  the dial; all at least ``birdie_spacing_hz`` from each other and from
  every beacon.  One of them, drawn from the seed, drifts sinusoidally
  with a peak rate of ``birdie_drift_hz_per_s`` (the spur manager's
  re-centre).
- Complex Gaussian noise of ``noise_sigma``; no impulses.

Seamless (:mod:`rxbench.ring`): every tone starts on the ring's grid,
each drift is one period of a sinusoid over the ring, and each message
is a whole number of elements that divides the ring.  :func:`layout`
draws everything from the generator before :func:`make_ring` draws its
noise."""

from __future__ import annotations

import math

import numpy as np
import torch

from rxbench import ring


def _uniform(gen: torch.Generator, n: int) -> np.ndarray:
    return torch.rand(n, generator=gen, device=gen.device,
                      dtype=torch.float64).cpu().numpy()


def _log_uniform(gen: torch.Generator, lo: float, hi: float) -> float:
    return float(lo * (hi / lo) ** _uniform(gen, 1)[0])


def message(gen: torch.Generator, elements: int) -> np.ndarray:
    """A keyed message of ``elements`` QRSS elements, 1 on and 0 off:
    dots and dashes with a gap after each, letter gaps now and then, the
    last element off."""
    out: list = []
    while len(out) < elements:
        dot, letter = _uniform(gen, 2) < (0.5, 0.3)
        out += [1] * (1 if dot else 3) + [0] * (3 if letter else 1)
    key = np.array(out[:elements], np.float32)
    key[-1] = 0.0
    return key


def layout(geo, spec: dict, gen: torch.Generator, dial_hz: float) -> dict:
    """Every tone of the ring, in the order drawn: lists ``kind``
    ("target", "beacon", "birdie"), ``cycles`` (whole cycles in the ring
    at the tone's centre), ``hz``, ``amp``, ``phase``, ``drift_hz`` (the
    sinusoid's peak in Hz), ``drift_phase`` and ``key`` (a message of
    elements, None for a birdie)."""
    fs = geo.timf1_sampling_speed
    length = spec["steps"] * geo.samples_per_step
    elements = max(1, int(round(length / fs / spec["element_s"])))
    period_s = length / fs
    tones = {k: [] for k in ("kind", "cycles", "hz", "amp", "phase",
                             "drift_hz", "drift_phase", "key")}

    def add(kind: str, hz: float, amp: float, rate: float, key) -> None:
        k = ring.cycles(hz, fs, length)
        phase, drift_phase = 2 * math.pi * _uniform(gen, 2)
        for name, v in (("kind", kind), ("cycles", k),
                        ("hz", k * fs / length), ("amp", amp),
                        ("phase", phase),
                        ("drift_hz", rate * period_s / (2 * math.pi)),
                        ("drift_phase", drift_phase), ("key", key)):
            tones[name].append(v)

    def clear(hz: float, gap: float) -> bool:
        return all(abs(hz - h) >= gap for h in tones["hz"])

    add("target", dial_hz + spec["target_offset_hz"],
        spec["target_amplitude"], spec["target_drift_hz_per_s"],
        message(gen, elements))
    lo, hi = spec["beacon_lo_hz"], spec["beacon_hi_hz"]
    while tones["kind"].count("beacon") < spec["beacons"]:
        hz = dial_hz + lo + (hi - lo) * float(_uniform(gen, 1)[0])
        if clear(hz, spec["beacon_spacing_hz"]):
            add("beacon", hz,
                _log_uniform(gen, spec["beacon_amp_lo"],
                             spec["beacon_amp_hi"]),
                spec["beacon_drift_hz_per_s"] * float(_uniform(gen, 1)[0]),
                message(gen, elements))
    birdies = spec["birdies_near"] + spec["birdies_far"]
    drifting = int(_uniform(gen, 1)[0] * birdies)
    near_lo, near_hi = spec["near_lo_hz"], spec["near_hi_hz"]
    while tones["kind"].count("birdie") < birdies:
        u, side = _uniform(gen, 2)
        if tones["kind"].count("birdie") < spec["birdies_near"]:
            offset = near_lo + (near_hi - near_lo) * u
            hz = dial_hz + (offset if side < 0.5 else -offset)
        else:
            hz = spec["far_edge_hz"] * (2 * u - 1)
            if abs(hz - dial_hz) <= near_hi + 100.0:
                continue
        if clear(hz, spec["birdie_spacing_hz"]):
            n = tones["kind"].count("birdie")
            add("birdie", hz,
                _log_uniform(gen, spec["birdie_amp_lo"],
                             spec["birdie_amp_hi"]),
                spec["birdie_drift_hz_per_s"] if n == drifting else 0.0,
                None)
    return tones


def make_ring(geo, spec: dict, gen: torch.Generator,
              dial_hz: float) -> np.ndarray:
    dev = gen.device
    fs = geo.timf1_sampling_speed
    length = spec["steps"] * geo.samples_per_step
    lay = layout(geo, spec, gen, dial_hz)
    x = ring.noise(gen, length, geo.channels, spec["noise_sigma"])
    n = ring.index(length, dev)
    turn = (2 * math.pi / length) * n.to(torch.float64)
    for k, amp, phase, drift, dphase, key in zip(
            lay["cycles"], lay["amp"], lay["phase"], lay["drift_hz"],
            lay["drift_phase"], lay["key"]):
        # f0 + A sin(2 pi t / T + d): its phase less A T cos(...)
        p = ring.tone_phase(k, length, dev) + phase
        if drift:
            p = p - drift * (length / fs) * torch.cos(turn + dphase)
        tone = ring.phasor(p, amp)
        if key is not None:
            m = len(key)
            tone = tone * torch.from_numpy(key).to(dev)[(n * m) // length]
        x += tone[:, None]
    return x.cpu().numpy()
