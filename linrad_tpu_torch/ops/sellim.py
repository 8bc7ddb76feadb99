"""Selective limiter — per-bin weak/strong classification (liminfo).

Port of linrad_tpu/ops/sellim.py (``fft1_update_liminfo``, reference
sellim.c:738-1157).  The liminfo contract (sellim.c:757-763):

    liminfo[i]  < 0  => bin to strong channel at unit gain
    liminfo[i] == 0  => bin to weak channel
    liminfo[i]  > 0  => bin to strong channel scaled by liminfo[i]

The steps and their order are those of the JAX version; see its module
docstring for the reference line numbers of each.  ``update_liminfo`` is
:func:`sellim_update` with the geometry's constants: on a CUDA tensor the
front and back kernels of ``csrc/sellim_update.cu`` (steps 1-4's gain and
budget with step 5's floor; steps 5-7) around the taper's launch, on a
CPU tensor its plain version :func:`_update_liminfo_reference`, the steps
as small tensor operations; a custom operator with a rule for
``torch.func.vmap``, so that R streams make three launches.  Step 4's
edge taper, a ``fori_loop`` of ``TAPER_STEPS`` passes there, is
:func:`sellim_taper`:
on a CUDA tensor one launch of the hand-written kernel in
``csrc/sellim_taper.cu``, which computes tiles of ``TAPER_TILE`` bins in
closed form (or, where the closed form's precondition fails, by the
passes over the tile and its halos); on a CPU tensor its plain version
:func:`_sellim_taper_reference`.  There is no fallback between the two.
It is a PyTorch custom operator with a rule for ``torch.func.vmap``: a
fleet of R receivers makes one launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..geometry import Geometry
from ..utils import cuda_build
from ..utils.segments import segment_max, segment_min, segment_sum
from .windows import make_window

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
    sel_lo/sel_hi: protected passband bin range (tensors), or None.

    :func:`sellim_update` with the geometry's constants: on a CUDA tensor
    the two kernels of ``csrc/sellim_update.cu`` around the taper's, on a
    CPU tensor its plain version :func:`_update_liminfo_reference`."""
    blocktime = geo.fft1_new_points / geo.timf1_sampling_speed
    wait_n = min(255, 1 + int(1.0 / max(
        geo.fft1_frames_per_step * blocktime, 1e-9)) + 1)
    # float32-rounded Python scalars, as JAX's jnp.float32 constants (a
    # tensor made from one would be a synchronising host-to-device copy)
    lim, wait = sellim_update(
        avg_power, state.liminfo, state.liminfo_wait, sel_lo, sel_hi,
        float(np.float32(sellim_limit(geo, maxlevel))),
        float(np.float32(ston)), geo.fft1_size // 2 if geo.iq_input else 0,
        wait_n, groups)
    return SellimState(liminfo=lim, liminfo_wait=wait)


def _update_liminfo_reference(avg_power: torch.Tensor,
                              liminfo: torch.Tensor,
                              liminfo_wait: torch.Tensor,
                              sel_lo: torch.Tensor | None,
                              sel_hi: torch.Tensor | None, limit: float,
                              ston: float, half: int, wait_n: int,
                              groups: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain PyTorch version of :func:`sellim_update`: steps 1-7 as small
    tensor operations, the taper through :func:`sellim_taper`.  Returns
    (liminfo, liminfo_wait)."""
    n = avg_power.shape[0]
    dev = avg_power.device
    # band-ascending order (bin n/2 first for IQ), as in the JAX version
    p = torch.roll(torch.clamp(avg_power, min=1e-30), half)
    old_liminfo = torch.roll(liminfo, half)
    old_wait = torch.roll(liminfo_wait, half)
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

    # 4. edge taper t^0.9 over (width/4)+1 extra bins
    width = segment_sum(torch.ones_like(p), strong)
    budget = torch.where(strong, width / 4.0 + 1.0, 0.0)
    lim = sellim_taper(lim, budget)

    # 5. noise floor: groups -> mean of 3 smallest (sellim.c:891-917)
    small3 = torch.topk(p.reshape(groups, n // groups), 3, dim=1,
                        largest=False, sorted=True).values
    gmin = small3.mean(1)
    gavg = gmin.mean()
    sel = gmin < 2.0 * gavg
    floor = (torch.where(sel, gmin, 0.0).sum()
             / torch.clamp(sel.sum(), min=1))
    thr = floor * ston
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
    return lim, wait


# ---- the edge taper: the kernel's wrapper and its plain version ---------

def _taper_pass(lim: torch.Tensor, budget: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass of the taper (the JAX ``taper_body``): (lim, budget)."""
    bl = _shift_right(budget)
    br = _shift_left(budget)
    cand = torch.maximum(torch.where(bl >= 1.0, _shift_right(lim), 0.0),
                         torch.where(br >= 1.0, _shift_left(lim), 0.0))
    new = (lim == 0.0) & (cand > 0.0)
    lim = torch.where(new, cand ** 0.9, lim)
    budget = torch.where(new, torch.maximum(bl - 1.0, br - 1.0), budget)
    return lim, budget


def _sellim_taper_reference(lim: torch.Tensor,
                            budget: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sellim_taper`: ``TAPER_STEPS``
    passes of small tensor operations."""
    for _ in range(TAPER_STEPS):
        lim, budget = _taper_pass(lim, budget)
    return lim


TAPER_TILE = 384        # the kernel's kTile: the bins a block writes
# launches of csrc/sellim_taper.cu, made and recorded into CUDA graphs
taper_count = cuda_build.launch_count("sellim_taper")
# the C launcher's argument types, the stream last, and the kernel's tile
TAPER_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 2
              + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
TAPER_CONSTANTS = (("lrt_sellim_taper_tile", TAPER_TILE),)


def taper_closed_form_holds(lim: torch.Tensor,
                            budget: torch.Tensor) -> bool:
    """The precondition of the kernel's closed form: every weak bin
    (``lim == 0``) has budget < 1."""
    return not bool(((lim == 0.0) & ~(budget < 1.0)).any())


def _check_taper(lim: torch.Tensor, budget: torch.Tensor) -> None:
    """Refuse what the kernel does not take: anything but (n,) float32
    tensors of one length on one device.

    Every (lim, budget) is taken and given the passes' result.  The kernel
    computes a tile in closed form where every weak bin of the tile and of
    its two halos of ``TAPER_STEPS`` bins has budget < 1
    (:func:`taper_closed_form_holds`), and runs the passes themselves over
    that window where one does not.  ``update_liminfo`` hands it
    ``lim = where(strong, gain, 0)`` and ``budget = where(strong,
    width/4 + 1, 0)``, which break the precondition only where a strong
    segment's gain is 0: a +inf power bin (``clamp(min=1e-30)`` keeps it,
    so the segment's maximum is inf) or ``maxlevel = 0`` (limit 0)."""
    if lim.dtype != torch.float32 or budget.dtype != torch.float32 \
            or lim.dim() != 1 or lim.shape != budget.shape \
            or lim.shape[0] == 0:
        raise ValueError(f"sellim_taper: lim and budget must be (n,) "
                         f"float32, got {tuple(lim.shape)} {lim.dtype} / "
                         f"{tuple(budget.shape)} {budget.dtype}")
    if lim.device != budget.device:
        raise ValueError("sellim_taper: tensors on different devices")


def _taper_launch(lim: torch.Tensor, budget: torch.Tensor,
                  paths: torch.Tensor | None = None) -> torch.Tensor:
    """One launch for R streams: lim (R, n), budget (R, n) or (n,) for
    every stream.  paths, where given, is an int32 tensor of (R, tiles)
    that the kernel sets to 1 where a tile ran the window loop and 0 where
    it took the closed form.  Returns the new lim (R, n)."""
    dev = lim.device
    r, n = lim.shape
    lim = lim.contiguous()
    budget = budget.contiguous()
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    cuda_build.launch(
        cuda_build.bind("sellim_taper", "lrt_sellim_taper", TAPER_ARGS,
                        expect=TAPER_CONSTANTS), (
            lim.data_ptr(), budget.data_ptr(), out.data_ptr(),
            None if paths is None else paths.data_ptr(), n,
            n if budget.dim() == 2 else 0, n, r), dev,
        f"sellim_taper at ({r}, {n})", taper_count)
    return out


_taper = cuda_build.Streams("sellim_taper", _check_taper,
                            _sellim_taper_reference, _taper_launch,
                            shared=(1,))


def taper_paths(lim: torch.Tensor, budget: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on a card, as :func:`sellim_taper` or its vmap rule
    makes it, that also reports each tile's path: (the new lim, (R,
    tiles) int32, 1 where the tile ran the window loop)."""
    _check_taper(lim[0] if lim.dim() == 2 else lim,
                 budget[0] if budget.dim() == 2 else budget)
    if lim.device.type != "cuda":
        raise ValueError(f"taper_paths: a CUDA tensor is needed, got "
                         f"{lim.device}")
    r = lim.shape[0] if lim.dim() == 2 else 1
    paths = torch.full((r, -(-lim.shape[-1] // TAPER_TILE)), -1,
                       dtype=torch.int32, device=lim.device)
    out = _taper_launch(lim.reshape(r, -1), budget, paths)
    return out if lim.dim() == 2 else out[0], paths


@torch.library.custom_op("linrad_tpu_torch::sellim_taper", mutates_args=())
def sellim_taper(lim: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Sellim's edge taper (``update_liminfo`` step 4).

    lim (n,) float32: the gains, 0 on weak bins; budget (n,) float32: the
    extra bins each strong bin may still hand on.  ``TAPER_STEPS`` passes,
    each giving every weak bin beside a strong one with budget left that
    bin's gain to the power 0.9 and one bin less of budget
    (edge-replicated neighbours).  Returns the new lim; no argument is
    changed.

    A PyTorch custom operator (``torch.ops.linrad_tpu_torch.sellim_taper``)
    with a rule for ``torch.func.vmap``: R streams, a budget each or one
    shared, make one launch, a grid of tiles by streams (``_taper.vmap``).
    Its launches are counted in ``taper_count``."""
    return _taper(lim, budget)


@sellim_taper.register_fake
def _sellim_taper_fake(lim, budget):
    _check_taper(lim, budget)
    return torch.empty_like(lim)


sellim_taper.register_vmap(_taper.vmap)


# ---- the update on the card: two kernels around the taper --------------

# launches of csrc/sellim_update.cu (its front and back kernels: two a
# call), made and recorded into CUDA graphs
update_count = cuda_build.launch_count("sellim_update")
UPDATE_MAX_GROUPS = 32  # the front kernel takes a group a warp
# the C launchers' argument types, the stream last
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
FRONT_ARGS = ((_PTR, _LL) * 2 + (_PTR,) * 4
              + (_INT, _INT, ctypes.c_float, ctypes.c_float, _INT, _INT,
                 _PTR))
BACK_ARGS = ((_PTR, _LL) * 3 + (_PTR,) * 4 + (_LL, _PTR, _PTR)
             + (_INT,) * 4 + (_PTR,))


def _check_update(avg_power, liminfo, liminfo_wait, sel_lo, sel_hi, limit,
                  ston, half, wait_n, groups) -> None:
    """Refuse what the update does not take: avg_power and liminfo (n,)
    float32 and liminfo_wait (n,) int32, a passband of two 0-d integer
    tensors or none, half 0 or n // 2, n a multiple of ``groups`` with at
    least 3 bins a group."""
    n = avg_power.shape[-1]
    if avg_power.dim() != 1 or n == 0 \
            or avg_power.dtype != torch.float32 \
            or liminfo.dtype != torch.float32 \
            or liminfo_wait.dtype != torch.int32 \
            or liminfo.shape != avg_power.shape \
            or liminfo_wait.shape != avg_power.shape:
        raise ValueError(f"sellim_update: avg_power and liminfo must be (n,) "
                         f"float32 and liminfo_wait (n,) int32, got "
                         f"{tuple(avg_power.shape)} {avg_power.dtype}, "
                         f"{tuple(liminfo.shape)} {liminfo.dtype}, "
                         f"{tuple(liminfo_wait.shape)} {liminfo_wait.dtype}")
    if (sel_lo is None) != (sel_hi is None) or sel_lo is not None and any(
            x.dim() != 0 or x.dtype.is_floating_point or x.dtype.is_complex
            or x.dtype == torch.bool for x in (sel_lo, sel_hi)):
        raise ValueError("sellim_update: sel_lo and sel_hi must both be 0-d "
                         "integer tensors, or both None")
    if half not in (0, n // 2) or groups < 1 or n % groups \
            or n // groups < 3:
        raise ValueError(f"sellim_update: half {half} and groups {groups} "
                         f"do not fit n = {n}")


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(R, n) rows whose bins are dense, and the rows' stride (0 where one
    row serves every stream)."""
    x = x if x.stride(-1) == 1 else x.contiguous()
    return x, x.stride(0)


def _update_launch(avg_power, liminfo, liminfo_wait, sel_lo, sel_hi, limit,
                   ston, half, wait_n, groups, scratch=None):
    """Three launches for R streams: the front kernel, the taper's, the
    back kernel.  avg_power, liminfo, liminfo_wait (R, n); sel_lo, sel_hi
    (R,), 0-d (one passband for every stream) or None.  Returns (liminfo,
    liminfo_wait), each (R, n).  scratch, where given, is a dict that gets
    the front kernel's outputs: the taper's arguments ``lim`` and
    ``budget`` (band order) and each stream's carrier threshold ``thr``."""
    dev = avg_power.device
    r, n = avg_power.shape
    if groups > UPDATE_MAX_GROUPS:
        raise ValueError(f"sellim_update: the kernel takes at most "
                         f"{UPDATE_MAX_GROUPS} groups, got {groups}")
    sels = () if sel_lo is None else (sel_lo, sel_hi)
    if any(x.device != dev for x in (liminfo, liminfo_wait, *sels)):
        raise ValueError("sellim_update: tensors on different devices")
    if any(x.dtype != torch.int64 for x in sels):
        raise ValueError("sellim_update: the kernel takes an int64 passband")
    sels = [x.contiguous() for x in sels]
    (avg, avg_s), (old, old_s), (wait, wait_s) = (
        _rows(x) for x in (avg_power, liminfo, liminfo_wait))
    f32 = dict(dtype=torch.float32, device=dev)
    lim0, budget = torch.empty((r, n), **f32), torch.empty((r, n), **f32)
    thr = torch.empty(r, **f32)
    work = torch.empty((r, n), dtype=torch.int32, device=dev)
    what = f"sellim_update at ({r}, {n})"
    cuda_build.launch(
        cuda_build.bind("sellim_update", "lrt_sellim_front", FRONT_ARGS), (
            avg.data_ptr(), avg_s, old.data_ptr(), old_s, lim0.data_ptr(),
            budget.data_ptr(), work.data_ptr(), thr.data_ptr(), n, half,
            limit, ston, groups, r), dev, what, update_count)
    tapered = _taper_launch(lim0, budget)
    out = torch.empty((r, n), **f32)
    out_wait = torch.empty((r, n), dtype=torch.int32, device=dev)
    lo, hi = (x.data_ptr() for x in sels) if sels else (None, None)
    cuda_build.launch(
        cuda_build.bind("sellim_update", "lrt_sellim_back", BACK_ARGS), (
            avg.data_ptr(), avg_s, old.data_ptr(), old_s, wait.data_ptr(),
            wait_s, tapered.data_ptr(), thr.data_ptr(), lo, hi,
            sels[0].dim() if sels else 0, out.data_ptr(),
            out_wait.data_ptr(), n, half, wait_n, r), dev, what,
        update_count)
    if scratch is not None:
        scratch.update(lim=lim0, budget=budget, thr=thr)
    return out, out_wait


_update = cuda_build.Streams("sellim_update", _check_update,
                             _update_liminfo_reference, _update_launch,
                             shared=(3, 4))


@torch.library.custom_op("linrad_tpu_torch::sellim_update", mutates_args=())
def sellim_update(avg_power: torch.Tensor, liminfo: torch.Tensor,
                  liminfo_wait: torch.Tensor, sel_lo: Optional[torch.Tensor],
                  sel_hi: Optional[torch.Tensor], limit: float, ston: float,
                  half: int, wait_n: int,
                  groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sellim's liminfo update (``update_liminfo``'s steps 1-7) with its
    constants: the power threshold ``limit`` and ``ston`` as float32
    values, ``half`` the roll to band order (n // 2 for IQ, else 0),
    ``wait_n`` the strong bins' hold count, ``groups`` the noise floor's
    groups.  Returns the new (liminfo, liminfo_wait); no argument is
    changed.

    A PyTorch custom operator (``torch.ops.linrad_tpu_torch.sellim_update``)
    with a rule for ``torch.func.vmap``: on a CUDA tensor three launches
    for R streams (``csrc/sellim_update.cu``'s front kernel, the taper's,
    its back kernel), a passband each or one shared; on a CPU tensor
    :func:`_update_liminfo_reference`.  The two kernels' launches are
    counted in ``update_count``."""
    return _update(avg_power, liminfo, liminfo_wait, sel_lo, sel_hi, limit,
                   ston, half, wait_n, groups)


@sellim_update.register_fake
def _sellim_update_fake(avg_power, liminfo, liminfo_wait, sel_lo, sel_hi,
                        limit, ston, half, wait_n, groups):
    _check_update(avg_power, liminfo, liminfo_wait, sel_lo, sel_hi, limit,
                  ston, half, wait_n, groups)
    return (torch.empty_like(avg_power),
            torch.empty_like(avg_power, dtype=torch.int32))


sellim_update.register_vmap(_update.vmap)


def liminfo_gains(liminfo: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bin (weak_gain, strong_gain) from liminfo (timf2.c:39-126)."""
    weak = torch.where(liminfo == 0.0, 1.0, 0.0).to(torch.float32)
    strong = torch.where(liminfo < 0.0, 1.0,
                         torch.where(liminfo > 0.0, liminfo, 0.0))
    return weak, strong.to(torch.float32)
