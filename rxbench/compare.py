"""The numbers that decide ``correct``: how far the port's stream-steps
lie from the plain reference's, field by field.

A step's reading of a field is its largest gap relative to the
reference's largest magnitude in that field of that step; the counts are
the liminfo bins whose sign (strong at unit gain, weak, strong scaled)
differs, the blankers' fitted plus cleared counts' difference, and with
an AFC the steps whose status differs.  Over a run's compared steps a
number is the largest reading (every field, the AFC's tuning) or the sum
(the counts).

One exception.  A blanker's threshold decision on a sample that lies
within rounding of its threshold can go either way on two correct float32
paths (the fused fft1 kernel and torch.fft differ by about 1e-7), and the
step where it does reads a gap of 0.01-0.2 in the narrowband fields
(audio, baseband, AGC gain).  Such a step, one whose blankers decided
apart from the reference's, gives no narrowband reading and counts one
``blanker_flips``, which has a limit of its own.  It shows as a step whose
fitted or cleared count differs, or whose fft2 power (taken from the
blanked signal) stands out from the run's other steps: further from the
reference's than ``APART_RATIO`` times the run's median step and than
``APART_FLOOR``.  Rounding reads under 7e-7 there, a decision gone the
other way 2.8e-5 or more (PERF.md); a lower precision or a broken path
moves every step alike, and so stands out nowhere.  Each number has a
limit per cell (``limits/<cell>.json``), set from the port's sound runs
and its lower-precision control (PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

REL_FIELDS = ("audio", "baseb", "agc_gain", "fft1_avg_power", "fft2_power",
              "liminfo")
# the fields downstream of the blankers' decisions, read only on steps
# whose blankers decided as the reference's did
NARROWBAND = ("audio", "baseb", "agc_gain")
# the numbers taken as a sum over a run's compared steps; the rest as the
# largest
SUMMED = ("liminfo_signs", "blanker_counts", "afc_status", "blanker_flips")
# where a step's fft2 power gap says that its blankers decided apart
APART_RATIO = 30.0
APART_FLOOR = 1e-5


def as_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_complex():
            return x.to(torch.complex128).numpy()
        return x.to(torch.float64).numpy()
    return np.asarray(x)


def max_rel(got, want) -> float:
    """max |got - want| / max |want|; inf where the port reads NaN or a
    shape differs."""
    g, w = as_array(got), as_array(want)
    if g.shape != w.shape:
        return math.inf
    gap = np.abs(g.astype(np.complex128) - w).max(initial=0.0)
    if not np.isfinite(gap):
        return math.inf
    scale = np.abs(w).max(initial=0.0)
    return float(gap / scale) if scale > 0 else float(gap)


def step_numbers(got: dict, want: dict) -> dict:
    """The readings of one stream-step: ``got`` the port's fields,
    ``want`` the reference's (absent or None: not compared)."""
    out = {}
    for f in REL_FIELDS:
        if want.get(f) is not None:
            out[f] = max_rel(got[f], want[f])
    if want.get("liminfo") is not None:
        out["liminfo_signs"] = float(
            (np.sign(as_array(got["liminfo"]))
             != np.sign(as_array(want["liminfo"]))).sum())
    if want.get("blanker_fitted") is not None:
        out["blanker_counts"] = float(sum(
            abs(count(got[f]) - count(want[f]))
            for f in ("blanker_fitted", "blanker_cleared")))
    return out


def count(x) -> int:
    """A step's count, a 0-dim or one-element array."""
    return int(as_array(x).reshape(-1)[0])


def tuning_gap(got: tuple, want: tuple, n: int) -> float:
    """Bins between two tunings (bin, fraction, slope): the gap of bin
    plus fraction (bins wrap at n) and of the slopes, the larger."""
    gb, gf, gs = (None if t is None else as_array(t) for t in got)
    wb, wf, ws = (None if t is None else as_array(t) for t in want)
    db = (gb - wb + n // 2) % n - n // 2
    gap = float(np.abs(db + gf - wf).max())
    if (gs is None) != (ws is None):
        return math.inf
    if gs is not None:
        gap = max(gap, float(np.abs(gs - ws).max()))
    return gap


def counts(got: dict, want: dict) -> dict:
    """The blankers' counts on both sides, where compared."""
    return {f"{side}_{f}": count(d[f]) for f in
            ("blanker_fitted", "blanker_cleared")
            for side, d in (("port", got), ("ref", want))
            if want.get(f) is not None}


def judged(records: list) -> list:
    """The compared steps ``records`` ((kind, readings, details) each) as
    they are judged: a step whose blankers decided apart from the
    reference's gives no narrowband reading and counts one blanker flip."""
    gaps = [nums["fft2_power"] for _kind, nums, _info in records
            if "fft2_power" in nums]
    level = (max(APART_FLOOR, APART_RATIO * float(np.median(gaps)))
             if gaps else math.inf)
    out = []
    for kind, nums, info in records:
        if "blanker_counts" in nums:
            apart = (nums["blanker_counts"] != 0
                     or nums.get("fft2_power", 0.0) > level)
            nums = {k: v for k, v in nums.items()
                    if not (apart and k in NARROWBAND)}
            nums["blanker_flips"] = float(apart)
        out.append((kind, nums, info))
    return out


def aggregate(records: list) -> dict:
    """Each number over the compared steps ``records`` ((kind, readings,
    details) each): the sum of a count, else the largest; NaN reads inf."""
    per: dict = {}
    for _kind, nums, _info in records:
        for k, v in nums.items():
            per.setdefault(k, []).append(math.inf if math.isnan(v) else v)
    return {k: float(sum(vals) if k in SUMMED else max(vals))
            for k, vals in per.items()}


def step_fails(nums: dict, limits: dict) -> bool:
    """Whether one step alone exceeds a limit."""
    return any(not (v <= limits.get(k, -1.0)) for k, v in nums.items())
