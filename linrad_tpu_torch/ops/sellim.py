"""Selective limiter — per-bin weak/strong classification (liminfo).

Port of linrad_tpu/ops/sellim.py (``fft1_update_liminfo``, reference
sellim.c:738-1157).  The liminfo contract (sellim.c:757-763):

    liminfo[i]  < 0  => bin to strong channel at unit gain
    liminfo[i] == 0  => bin to weak channel
    liminfo[i]  > 0  => bin to strong channel scaled by liminfo[i]

The steps and their order are those of the JAX version; see its module
docstring for the reference line numbers of each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from linrad_tpu.geometry import Geometry
from linrad_tpu.ops.windows import make_window

from ..utils.segments import segment_max, segment_min, segment_sum

RELEASE_FACTOR = 1.15   # sellim.c:35
SFAC = 2.0              # sellim.c:36
TAPER_STEPS = 64        # edge-taper reach, as in the JAX version

_INF = float("inf")


def _chain_reach(strong: torch.Tensor, q: torch.Tensor,
                 reverse: bool) -> torch.Tensor:
    """r[i] = strong[i] | (q[i] & r[prev]) along the scan direction — the
    reference's skirt walk (sellim.c:801-802).  Closed form: r[i] holds
    when the last strong index at or before i is at or after the last
    index where q is false (every bin in between continues the chain)."""
    if reverse:
        return _chain_reach(strong.flip(0), q.flip(0), False).flip(0)
    idx = torch.arange(strong.shape[0], device=strong.device)
    last_strong = torch.cummax(torch.where(strong, idx, -1), 0).values
    last_break = torch.cummax(torch.where(q, -1, idx), 0).values
    return (last_strong >= 0) & (last_strong >= last_break)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """x[i-1], edge-replicated (the JAX concatenate([x[:1], x[:-1]]))."""
    return torch.cat([x[:1], x[:-1]])


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """x[i+1], edge-replicated."""
    return torch.cat([x[1:], x[-1:]])


@dataclass
class SellimState:
    liminfo: torch.Tensor       # (fft1_size,) float32
    liminfo_wait: torch.Tensor  # (fft1_size,) int32

    @classmethod
    def create(cls, geo: Geometry, device) -> "SellimState":
        return cls(liminfo=torch.zeros(geo.fft1_size, dtype=torch.float32,
                                       device=device),
                   liminfo_wait=torch.zeros(geo.fft1_size, dtype=torch.int32,
                                            device=device))


def sellim_limit(geo: Geometry, maxlevel: float) -> float:
    """Copy of linrad_tpu.ops.sellim.sellim_limit: the strong-signal power
    threshold on the averaged fft1 spectrum (sellim.c:783-786), with
    ``maxlevel`` in input-amplitude units converted through the window's
    coherent gain."""
    winsum = float(make_window(geo.fft1_size, geo.fft1_sinpow).sum())
    return ((maxlevel * winsum) ** 2 * geo.channels * geo.fft1_size
            / max(geo.fft2_size, geo.fft1_size))


def update_liminfo(geo: Geometry, state: SellimState,
                   avg_power: torch.Tensor, maxlevel: float,
                   ston: float = 30.0, sel_lo: torch.Tensor | None = None,
                   sel_hi: torch.Tensor | None = None,
                   groups: int = 32) -> SellimState:
    """One liminfo update from the averaged fft1 power spectrum.

    avg_power: (fft1_size,) float32, power summed over channels.
    sel_lo/sel_hi: protected passband bin range (tensors), or None."""
    n = geo.fft1_size
    dev = avg_power.device
    # band-ascending order (bin n/2 first for IQ), as in the JAX version
    half = n // 2 if geo.iq_input else 0
    p = torch.roll(torch.clamp(avg_power, min=1e-30), half)
    old_liminfo = torch.roll(state.liminfo, half)
    old_wait = torch.roll(state.liminfo_wait, half)
    # float32-rounded Python scalars, as JAX's jnp.float32 constants (a
    # tensor made from one would be a synchronising host-to-device copy)
    limit = float(np.float32(sellim_limit(geo, maxlevel)))

    # 1. threshold + 2. skirt extension
    strong = p > limit
    q_dn = p < 0.3 * _shift_right(p)
    q_up = p < 0.3 * _shift_left(p)
    strong = (_chain_reach(strong, q_dn, reverse=False)
              | _chain_reach(strong, q_up, reverse=True))

    # 3. common region gain with temporal smoothing
    maxval = segment_max(p, strong)
    # a true division (float / tensor would be reciprocal() * float)
    gain = torch.sqrt(torch.full_like(p, limit)
                      / torch.clamp(maxval, min=limit))
    old_pos = torch.where(old_liminfo > 0, old_liminfo, _INF)
    old_gain = segment_min(old_pos, strong)
    ratio = old_gain / torch.clamp(gain, min=1e-20)
    smooth = (ratio > 0.1) & (ratio < 10.0) & torch.isfinite(old_gain)
    gain = torch.where(smooth, 0.8 * old_gain + 0.2 * gain, gain)
    lim = torch.where(strong, gain, 0.0)

    # 4. edge taper t^0.9 over (width/4)+1 extra bins; a fixed number of
    # passes over device tensors (no host sync per pass)
    width = segment_sum(torch.ones_like(p), strong)
    budget = torch.where(strong, width / 4.0 + 1.0, 0.0)
    for _ in range(TAPER_STEPS):
        bl = _shift_right(budget)
        br = _shift_left(budget)
        cand = torch.maximum(torch.where(bl >= 1.0, _shift_right(lim), 0.0),
                             torch.where(br >= 1.0, _shift_left(lim), 0.0))
        new = (lim == 0.0) & (cand > 0.0)
        lim = torch.where(new, cand ** 0.9, lim)
        budget = torch.where(new, torch.maximum(bl - 1.0, br - 1.0), budget)

    # 5. noise floor: groups -> mean of 3 smallest (sellim.c:891-917)
    small3 = torch.topk(p.reshape(groups, n // groups), 3, dim=1,
                        largest=False, sorted=True).values
    gmin = small3.mean(1)
    gavg = gmin.mean()
    sel = gmin < 2.0 * gavg
    floor = (torch.where(sel, gmin, 0.0).sum()
             / torch.clamp(sel.sum(), min=1))
    thr = floor * float(np.float32(ston))
    carrier = (p > thr) & (lim == 0.0)
    # SFAC skirt: extend while the inner neighbour is >2x larger
    p_l = _shift_right(p)
    p_r = _shift_left(p)
    for _ in range(4):
        grow = ((_shift_right(carrier) & (SFAC * p < p_l))
                | (_shift_left(carrier) & (SFAC * p < p_r)))
        carrier = carrier | (grow & (lim == 0.0))
    lim = torch.where(carrier & (lim == 0.0), -1.0, lim)

    # 6. wait counters + release limiting
    blocktime = geo.fft1_new_points / geo.timf1_sampling_speed
    wait_n = min(255, 1 + int(1.0 / max(
        geo.fft1_frames_per_step * blocktime, 1e-9)) + 1)
    is_strong = lim != 0.0
    wait = torch.where(is_strong, wait_n,
                       torch.clamp(old_wait - 1, min=0)).to(torch.int32)
    lim = torch.where(~is_strong & (wait > 0), -1.0, lim)
    cap = torch.where(old_liminfo > 0, old_liminfo * RELEASE_FACTOR, _INF)
    lim = torch.where((lim > 0) & (lim > cap) & (cap < 1.0), cap, lim)

    # 7. outermost (band-edge) bins forced weak (sellim.c:1152-1157)
    idx = torch.arange(n, device=dev)
    lim = torch.where((idx < 2) | (idx >= n - 2), 0.0, lim)

    # back to DC-at-0 bin order, then the protected passband
    lim = torch.roll(lim, -half)
    wait = torch.roll(wait, -half)
    if sel_lo is not None:
        in_sel = (idx >= sel_lo) & (idx <= sel_hi)
        lim = torch.where(in_sel, 0.0, lim)
        wait = torch.where(in_sel, 0, wait)
    return SellimState(liminfo=lim, liminfo_wait=wait)


def liminfo_gains(liminfo: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin (weak_gain, strong_gain) from liminfo (timf2.c:39-126)."""
    weak = torch.where(liminfo == 0.0, 1.0, 0.0).to(torch.float32)
    strong = torch.where(liminfo < 0.0, 1.0,
                         torch.where(liminfo > 0.0, liminfo, 0.0))
    return weak, strong.to(torch.float32)
