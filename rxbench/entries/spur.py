"""Entry ``spur``: the receiver entry's closed loop
(:mod:`rxbench.entries.receiver`: each block in as a host array, its
audio back to the host before the next) on a receiver whose spur
canceller runs, with the spur manager's decisions held to the
reference's.

The check is the receiver entry's, with the spur manager beside the AFC:
the port's manager (its slots' ages, host state that the receiver state
does not hold) is copied just before each kept block and seeds the
reference's manager there.  The AFC's copy also carries its last drift
fit (``_coef``, ``_t0``: attributes outside its dataclass fields, which
the receiver entry's copy leaves behind), which ``predict`` extrapolates
on a block whose AFC point is not good: a QRSS beacon is keyed off for
whole blocks.  After every compared block two more numbers are read:

- ``spur_bins``: the slots whose centre bin or age differs from the
  reference's (a slot added, dropped or re-centred apart);
- ``spur_model``: over the slots active on either side, the largest gap
  of the tracked amplitude, rotation and fractional offset, each relative
  to its largest magnitude in the reference.

Nothing here reads a name that a port without the spur spans lacks.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from rxbench import compare
from rxbench.core import Run
from rxbench.entries import receiver
from rxbench.entries.receiver import afc_state, block_readings, outputs

SPUR_FIELDS = ("bins", "amp", "rot", "frac")


def spur_after(rx) -> dict:
    """The spur slots after a block: copies of the state's four tensors
    (on the device, no wait) and the manager's ages."""
    spur = rx.state.spur
    out = {f: getattr(spur, f).detach().clone() for f in SPUR_FIELDS}
    out["age"] = dict(rx.control.spur_manager._age)
    return out


def counted(names: tuple) -> dict:
    """The tracer's counters of ``names``; None for one the port lacks."""
    from linrad_tpu_torch.utils import trace
    return {k: trace.counters.get(k) for k in names}


class Session(receiver.Session):
    """The receiver entry's session; each kept block also keeps the spur
    manager before it and the slots after it."""

    def __init__(self, run: Run):
        super().__init__(run)
        bins = self.rx.state.spur.bins.cpu().numpy()
        run.note(f"rxbench: spur slots active after the warm-up: "
                 f"{int((bins >= 0).sum())}, at fftx bins "
                 f"{sorted(int(b) for b in bins if b >= 0)}")

    def window(self, seconds: float, times: list) -> dict:
        names = ("spur_scans", "spur_adds", "spur_drops", "spur_shifts")
        before = counted(names)
        win = super().window(seconds, times)
        after = counted(names)
        self.run.note("rxbench: spur manager in the window: " + ", ".join(
            f"{k} {None if after[k] is None else after[k] - before[k]}"
            for k in names))
        return win

    def after(self) -> tuple:
        return (*super().after(), spur_after(self.rx))

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["spur"] = copy.deepcopy(self.rx.control.spur_manager)
        return snap


def setup(run: Run) -> Session:
    return Session(run)


def manager_state(ref_cls, geo, manager) -> object:
    """The port's spur manager as the reference's class: the fields the
    reference has, copied, its own geometry."""
    return ref_cls(geo=geo, **{
        f.name: copy.deepcopy(getattr(manager, f.name))
        for f in dataclasses.fields(ref_cls) if f.name != "geo"})


def afc_copy(ref_afc_cls, ref_cfg_cls, geo, afc) -> object:
    """The receiver entry's copy of the port's AFC tracker, with the
    attributes it keeps outside its dataclass fields (its last fit)."""
    out = afc_state(ref_afc_cls, ref_cfg_cls, geo, afc)
    for name, value in vars(afc).items():
        if not hasattr(out, name):
            setattr(out, name, copy.deepcopy(value))
    return out


def spur_readings(got: dict, ref) -> dict:
    """``spur_bins`` and ``spur_model`` of one block: the port's slots
    after it (:func:`spur_after`) against the reference's."""
    want = ref.state.spur
    ages = ref.control.spur_manager._age
    gb = compare.as_array(got["bins"]).astype(np.int64)
    wb = compare.as_array(want.bins).astype(np.int64)
    apart = (gb != wb) | np.array([got["age"].get(s) != ages.get(s)
                                   for s in range(len(wb))])
    active = (gb >= 0) | (wb >= 0)
    model = 0.0
    if active.any():
        model = max(compare.max_rel(compare.as_array(got[f])[active],
                                    compare.as_array(getattr(want, f))[active])
                    for f in SPUR_FIELDS[1:])
    return {"spur_bins": float(apart.sum()), "spur_model": model}


def check(run: Run, data: dict) -> list:
    """(kind, readings, details) of every compared block: the start from
    fresh states, then the window's samples from the port's state, tuning,
    AFC and spur manager; each with the spur readings."""
    from rxbench.reference.receiver import PlainReceiver, with_leaves
    from rxbench.reference.weak.afc import AFCConfig, AFCTracker
    from rxbench.reference.weak.spur import SpurManager
    dev = torch.device(run.device)
    n = data["fftx_size"]
    blocks = data["blocks"]
    records = []
    ref = PlainReceiver(run.reference_params(), dev)
    ref.tune(run.traffic["dial_hz"])

    def one(kind, block, got, status, tune, spur, index):
        want = ref.process_block(torch.from_numpy(block).to(dev))
        nums, info = block_readings(got, outputs(want), ref, status, tune, n,
                                    index)
        nums.update(spur_readings(spur, ref))
        records.append((kind, nums, info))

    for k, (got, status, tune, spur) in enumerate(data["start"]):
        one("start", blocks[k % len(blocks)], got, status, tune, spur, k)
    template = ref.state
    for index, snap, got, status, tune, spur in data["samples"]:
        ref.state = with_leaves(template, [t.to(dev) for t in snap["state"]])
        ref.tune_bin, ref.tune_frac, ref.tune_slope = (
            None if t is None else t.to(dev) for t in snap["tuning"])
        c = ref.control
        if snap["afc"] is not None:
            c.afc = afc_copy(AFCTracker, AFCConfig, ref.geo, snap["afc"])
        c._afc_subbuf = copy.deepcopy(snap["subbuf"])
        c.steps_done = snap["steps_done"]
        c.spur_manager = manager_state(SpurManager, ref.geo, snap["spur"])
        one("window", blocks[index], got, status, tune, spur, index)
    return records
