"""Noise blankers on the weak timf2 channel (port of
linrad_tpu/ops/blanker.py, reference ``first_noise_blanker``
blank1.c:684-1603).

Clever blanker: fit-and-subtract the strongest candidate pulse against a
bank of fractionally shifted reference pulses (blank1.c:36-232), up to
``max_pulses`` times in sequence.  Stupid blanker: hard-clear every run
above threshold, widened by the sqrt(peak/noise)/100 rule
(blank1.c:1013-1083).

The blocked search's fit loop is :func:`blanker_fits`, here its plain
version :func:`_blanker_fits_reference` (``max_pulses`` iterations of
small tensor operations), where the port launches a CUDA kernel.

The flat search (``block_size=0``, a cross-check that no preset selects)
and the round-parallel variant (``rounds>0``, which fits every locally
dominant block's strongest candidate at once, ``rounds`` times) stay in
PyTorch: their loops run on device tensors, every dynamic position an
index tensor, so they never wait for the host, and ``torch.func.vmap``
batches their in-place ``index_put_``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from ..utils.segments import segment_max

MAX_REFPULSES = 256  # fractional-shift bank depth (blnkdef.h:13)


def make_refpulse_bank(freq_response: np.ndarray, pul_size: int,
                       n_pulses: int = MAX_REFPULSES
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """Copy of linrad_tpu.ops.blanker.make_refpulse_bank.

    freq_response: (N,) complex system response an impulse sees.
    Returns (bank (n_pulses, pul_size) complex64, phasefunc (pul_size,)
    complex64, pulsewidth int — the -15 dB half width, min 2)."""
    n = len(freq_response)
    k = np.fft.fftfreq(n) * n  # signed bin numbers
    half = pul_size // 2
    fracs = np.arange(n_pulses) / n_pulses - 0.5
    bank = np.zeros((n_pulses, pul_size), np.complex128)
    for j, d in enumerate(fracs):
        ramp = np.exp(-2j * np.pi * k * d / n)
        pulse = np.fft.ifft(freq_response * ramp)
        rolled = np.roll(pulse, half)[:pul_size]
        peak = rolled[half]
        if abs(peak) < 1e-12:
            peak = 1.0
        bank[j] = rolled / peak
    # phase function from the unshifted response (blanker_phasefunc)
    p0 = np.roll(np.fft.ifft(freq_response), half)[:pul_size]
    mag = np.abs(p0)
    unit = np.where(mag > 1e-9 * mag.max(), p0 / np.maximum(mag, 1e-30),
                    1.0)
    phasefunc = np.conj(unit)
    # -15 dB pulse width (power > 0.033 of peak), minimum 2
    pw = 2
    ppow = np.abs(p0) ** 2
    while half + pw < pul_size and ppow[half + pw] > 0.033 * ppow[half]:
        pw += 1
    pw = min(pw, half - 2)
    return (bank.astype(np.complex64), phasefunc.astype(np.complex64),
            max(pw, 2))


@dataclass(frozen=True)
class BlankerTables:
    refbank: torch.Tensor    # (n_pulses, pul_size) complex64
    phasefunc: torch.Tensor  # (pul_size,) complex64

    @classmethod
    def create(cls, geo: Geometry, device,
               freq_response: np.ndarray | None = None,
               pul_size: int = 64) -> tuple["BlankerTables", int]:
        if freq_response is None:
            freq_response = np.ones(geo.fft1_size, np.complex128)
        bank, pf, pw = make_refpulse_bank(freq_response, pul_size)
        return (cls(refbank=torch.from_numpy(bank).to(device),
                    phasefunc=torch.from_numpy(pf).to(device)), pw)


@dataclass
class BlankerState:
    noise_floor: torch.Tensor  # () float32 — despiked weak power / point

    @classmethod
    def create(cls, geo: Geometry, device) -> "BlankerState":
        # start 23 dB above one-bit amplitude (buf.c:415-427)
        return cls(noise_floor=torch.tensor(200.0, dtype=torch.float32,
                                            device=device))


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX version's jnp.float32 constants.
    Kept a Python scalar: a tensor made from it would be a host-to-device
    copy, which synchronises the stream, inside every step."""
    return float(np.float32(x))


def _threshold(limit_amp: float, noise_floor: torch.Tensor) -> torch.Tensor:
    return noise_floor * _f32(limit_amp * limit_amp)


def _pad_rows(x: torch.Tensor, lead: int, trail: int, value=0) -> torch.Tensor:
    shape = (lead,) + tuple(x.shape[1:])
    tshape = (trail,) + tuple(x.shape[1:])
    return torch.cat([x.new_full(shape, value), x, x.new_full(tshape, value)])


def _fit(win: torch.Tensor, oldp: torch.Tensor, tables: BlankerTables,
         pw: int, valid: torch.Tensor):
    """The fit-and-subtract test on fit windows win (..., pul, C) with
    their powers oldp (..., pul) (blank1.c:36-232); any leading axes are
    independent fits.  Returns (the windows to write back, their powers,
    the success flags (...)): the subtracted window where the fit
    succeeds, the window as it was elsewhere."""
    bank = tables.refbank
    nref, pul = bank.shape
    half = pul // 2
    derot = win * tables.phasefunc[:, None]
    ctr = derot[..., half - 1: half + 2, :]                  # (..., 3, C)
    ph = (ctr.abs() * ctr).sum(-2)                           # (..., C)
    unit = ph / torch.clamp(ph.abs(), min=1e-20)
    rot = derot * unit.conj()[..., None, :]
    seg = rot[..., half - pw: half + pw + 1, :]
    ipow = (seg.real ** 2).sum((-2, -1))
    qpow = (seg.imag ** 2).sum((-2, -1))
    shape_ok = qpow <= 0.25 * ipow                           # blank1.c:121
    a = rot.real.sum(-1)                                     # (..., pul)
    t3 = 2.0 * (a[..., half - 1] + a[..., half + 1] - 2.0 * a[..., half])
    t4 = torch.where(t3.abs() > 1e-20,
                     (a[..., half - 1] - a[..., half + 1]) / t3, 0.0)
    frac = torch.sign(t4) * torch.sqrt(0.5 * t4.abs())
    # clamp before truncating: XLA's float->int conversion saturates
    j = torch.clamp(nref * (frac + 0.5) + 0.5, 0, nref - 1).to(torch.int64)
    ref = bank.index_select(0, j.reshape(-1)).reshape(j.shape + (pul,))
    # a true pulse is win = coef * bank_j with coef = A*e^{i*phi}
    # (blank1.c:157-162)
    coef = unit * rot[..., half, :].real                     # (..., C)
    neww = win - ref[..., :, None] * coef[..., None, :]
    newp = (neww.real ** 2 + neww.imag ** 2).sum(-1)
    ratio = newp.sum(-1) / torch.clamp(oldp.sum(-1), min=1e-20)
    success = valid & shape_ok & (ratio <= 0.5)              # blank1.c:188
    return (torch.where(success[..., None, None], neww, win),
            torch.where(success[..., None], newp, oldp), success)


def _fit_subtract(wpad: torch.Tensor, ppad: torch.Tensor,
                  tables: BlankerTables, pw: int, p: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """One fit-and-subtract attempt at candidate position ``p`` (0-dim
    index tensor), in place on ``wpad``/``ppad``; returns the 0-dim
    success flag.  The window start is clamped into the array, as JAX's
    dynamic_slice clamps it."""
    total = wpad.shape[0]
    pul = tables.refbank.shape[1]
    start = torch.clamp(p - pul // 2, 0, total - pul)
    rows = start + torch.arange(pul, device=wpad.device)
    wvals, pvals, success = _fit(wpad.index_select(0, rows),
                                 ppad.index_select(0, rows), tables, pw,
                                 valid)
    wpad.index_put_((rows,), wvals)
    ppad.index_put_((rows,), pvals)
    return success


def clever_blanker(weak: torch.Tensor, pwr: torch.Tensor,
                   tables: BlankerTables, noise_floor: torch.Tensor,
                   limit_amp: float, pulsewidth: int, max_pulses: int,
                   block_size: int = 256, rounds: int = 0,
                   eligible: torch.Tensor | None = None):
    """Fit-and-subtract up to ``max_pulses`` pulses from the weak stream.

    weak: (S, C) complex64; pwr: (S,) float32 channel-summed power.
    Returns (weak', pwr', fitted_count (0-dim int32)).

    ``block_size`` > 0 keeps block maxima of the candidate power so each
    iteration reads O(S/block_size + block_size) values;
    ``block_size=0`` is the flat global argmax, kept to cross-check.

    ``rounds`` > 0 selects the round-parallel variant instead: per round,
    the strongest candidate of every locally dominant block (of
    ``block_size or 256`` samples) is fitted and subtracted at once, so
    the sequential depth is ``rounds``, not ``max_pulses``.

    ``eligible`` (S,) bool restricts the candidate centres of every variant
    (the fit windows still read every sample): the time-sharded step marks
    its halo samples ineligible, so that each pulse is fitted by exactly
    one shard."""
    if rounds:
        return _clever_blanker_parallel(weak, pwr, tables, noise_floor,
                                        limit_amp, pulsewidth, rounds,
                                        block_size or 256, eligible)
    if block_size:
        return _clever_blanker_blocked(weak, pwr, tables, noise_floor,
                                       limit_amp, pulsewidth, max_pulses,
                                       block_size, eligible)
    s, _c = weak.shape
    pul = tables.refbank.shape[1]
    pw = pulsewidth
    thr = _threshold(limit_amp, noise_floor)
    wpad = _pad_rows(weak, pul, pul)
    ppad = _pad_rows(pwr, pul, pul)
    active = _pad_rows(_active(s, weak.device, eligible), pul, pul, False)
    total = wpad.shape[0]
    span = torch.arange(2 * pw + 1, device=weak.device)
    nfit = torch.zeros((), dtype=torch.int32, device=weak.device)
    for _ in range(max_pulses):
        cand = torch.where(active, ppad, -1.0)
        p = torch.argmax(cand)
        valid = cand.index_select(0, p.reshape(1))[0] > thr
        success = _fit_subtract(wpad, ppad, tables, pw, p, valid)
        # retire the candidate region so the loop progresses
        rpos = torch.clamp(p - pw, 0, total - (2 * pw + 1)) + span
        active.index_put_((rpos,), active.index_select(0, rpos) & ~valid)
        nfit = nfit + success.to(torch.int32)
    return wpad[pul: pul + s], ppad[pul: pul + s], nfit


def _active(s: int, device, eligible: torch.Tensor | None) -> torch.Tensor:
    """The candidate centres a sequential scan starts from: all S samples,
    or the ``eligible`` ones."""
    if eligible is None:
        return torch.ones(s, dtype=torch.bool, device=device)
    return eligible


def _clever_blanker_blocked(weak, pwr, tables, noise_floor, limit_amp,
                            pulsewidth, max_pulses, blk, eligible=None):
    """Hierarchical candidate search: block maxima kept up to date so each
    iteration reads O(S/blk + blk) values.  Selection order matches the
    flat scan (the global argmax is the argmax over block maxima).  The
    padding, the candidate power and its block maxima are built here; the
    fits are :func:`blanker_fits`."""
    s, _c = weak.shape
    pul = tables.refbank.shape[1]
    pw = pulsewidth
    if not pul + 2 * pw + 1 < blk:
        raise ValueError(f"blanker block {blk} too small for pulse "
                         f"{pul} and width {pw}")
    thr = _threshold(limit_amp, noise_floor)
    lead = pul
    total = max(-(-(s + 2 * pul) // blk) * blk, 2 * blk)
    trail = total - s - lead
    wpad = _pad_rows(weak, lead, trail)
    ppad = _pad_rows(pwr, lead, trail)
    active = _pad_rows(_active(s, weak.device, eligible), lead, trail, False)
    candp = torch.where(active, ppad, -1.0)
    bmax = candp.reshape(total // blk, blk).amax(1)
    return blanker_fits(wpad, ppad, candp, bmax, tables.refbank,
                        tables.phasefunc, thr, pw, max_pulses, lead, s)


# ---- the sequential fits: the plain version ----------------------------

def _blanker_fits_reference(wpad, ppad, candp, bmax, refbank, phasefunc,
                            thr, pw: int, max_pulses: int, lead: int,
                            s: int):
    """Plain PyTorch version of :func:`blanker_fits`: ``max_pulses``
    iterations of the blocked search's fit loop (JAX
    ``_clever_blanker_blocked``'s ``fori_loop``) on copies of the padded
    arrays, updated in place."""
    wpad, ppad, candp, bmax = (x.clone() for x in (wpad, ppad, candp, bmax))
    tables = BlankerTables(refbank=refbank, phasefunc=phasefunc)
    dev = wpad.device
    nblk = bmax.shape[0]
    blk = wpad.shape[0] // nblk
    half = refbank.shape[1] // 2
    two = torch.arange(2, device=dev)
    win2 = torch.arange(2 * blk, device=dev)
    nfit = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_pulses):
        b = torch.argmax(bmax).reshape(1)
        cblk = candp.reshape(nblk, blk).index_select(0, b)[0]
        p = b[0] * blk + torch.argmax(cblk)
        valid = bmax.index_select(0, b)[0] > thr
        success = _fit_subtract(wpad, ppad, tables, pw, p, valid)
        # retire the candidate region, refresh powers where the
        # subtraction changed them, rebuild the two touched block maxima
        b0 = torch.clamp(torch.div(p - half - pw, blk, rounding_mode="floor"),
                         0, nblk - 2)
        pos = b0 * blk + win2
        pwin = ppad.index_select(0, pos)
        cwin = candp.index_select(0, pos)
        retired = (pos - p).abs() <= pw
        act2 = (cwin >= 0.0) & ~(valid & retired)
        cwin2 = torch.where(act2, pwin, -1.0)
        candp.index_put_((pos,), cwin2)
        bmax.index_put_((b0 + two,), cwin2.reshape(2, blk).amax(1))
        nfit = nfit + success.to(torch.int32)
    return wpad[lead: lead + s], ppad[lead: lead + s], nfit


# the plain loop stands where the port launches its fits kernels
blanker_fits = _blanker_fits_reference


def _clever_blanker_parallel(weak, pwr, tables, noise_floor, limit_amp,
                             pulsewidth, rounds, blk, eligible=None):
    """Round-parallel fit-subtract: every round fits the strongest
    candidate of each locally dominant block at once.

    A block is selected only when its maximum beats the block before it
    and is not beaten by the block after it, so two adjacent blocks are
    never both selected: their candidates are at least blk+1 > pul + 2 pw
    apart, the fit windows are disjoint, and the subtractions equal the
    same ones made one after the other.  Per round: one block max and
    argmax over (nblk, blk), a gather of the (nblk, pul, C) windows, the
    fit of :func:`_fit` on all of them, and a scatter back in place.  A
    block that is not selected writes to one sink row past the end of the
    padded arrays, which is sliced off: several such writes may land
    there in any order, and every real row is written by one window at
    most, so the result does not depend on the order."""
    s, c = weak.shape
    dev = weak.device
    pul = tables.refbank.shape[1]
    half = pul // 2
    pw = pulsewidth
    if not pul + 2 * pw + 1 <= blk:
        raise ValueError(f"blanker block {blk} too small for pulse "
                         f"{pul} and width {pw}")
    thr = _threshold(limit_amp, noise_floor)
    # one whole block of padding on each side: every fit window at a real
    # candidate stays inside, and padded candidates (-1) never win
    lead = blk
    total = (-(-(lead + s) // blk) + 1) * blk
    trail = total - s - lead
    wpad = _pad_rows(weak, lead, trail + 1)
    ppad = _pad_rows(pwr, lead, trail + 1)
    cand0 = pwr if eligible is None else torch.where(eligible, pwr, -1.0)
    candp = _pad_rows(cand0, lead, trail + 1, -1.0)
    nblk = total // blk
    first = torch.arange(nblk, device=dev) * blk
    rel = torch.arange(pul, device=dev) - half
    edge = torch.full((1,), -float("inf"), device=dev)
    nfit = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(rounds):
        cand2 = candp[:total].reshape(nblk, blk)
        bmax = cand2.amax(1)
        p = first + torch.argmax(cand2, 1)                   # (nblk,)
        # the block before must lose, the block after must not win: the
        # earlier block wins ties, as an argmax over them would
        bprev = torch.cat([edge, bmax[:-1]])
        bnext = torch.cat([bmax[1:], edge])
        sel = (bmax > thr) & (bmax > bprev) & (bmax >= bnext)
        rows = p[:, None] + rel[None, :]                     # (nblk, pul)
        flat = torch.clamp(rows, 0, total - 1).reshape(-1)
        win = wpad.index_select(0, flat).reshape(nblk, pul, c)
        oldp = ppad.index_select(0, flat).reshape(nblk, pul)
        wvals, pvals, success = _fit(win, oldp, tables, pw, sel)
        # retire +-pw around each fitted candidate (inside its window)
        cold = candp.index_select(0, flat).reshape(nblk, pul)
        retired = (rows - p[:, None]).abs() <= pw
        cvals = torch.where(retired | (cold < 0.0), -1.0, pvals)
        dest = (torch.where(sel[:, None], rows, total),)
        wpad.index_put_(dest, wvals)
        ppad.index_put_(dest, pvals)
        candp.index_put_(dest, cvals)
        nfit = nfit + success.sum().to(torch.int32)
    return wpad[lead: lead + s], ppad[lead: lead + s], nfit


def stupid_blanker(weak: torch.Tensor, pwr: torch.Tensor,
                   noise_floor: torch.Tensor, limit_amp: float,
                   pulsewidth: int):
    """Hard-clear every run above threshold, widened by the
    sqrt(peak/noise)/100 rule (blank1.c:1013-1083).

    Returns (weak', pwr', cleared_count (0-dim int32))."""
    s = pwr.shape[0]
    thr = _threshold(limit_amp, noise_floor)
    flagged = pwr > thr
    runmax = segment_max(pwr, flagged)
    t = torch.sqrt(torch.clamp(runmax / torch.clamp(noise_floor, min=1e-20),
                               0.0, 1e4)) / 100.0
    widen = flagged & (runmax > 4.0 * noise_floor)
    before = torch.where(widen, ((pulsewidth + 1) // 2) * t + 0.5, 0.0)
    after = torch.where(widen, (pulsewidth + 1) * t + 0.5, 0.0)
    pos = torch.arange(s, dtype=torch.float32, device=pwr.device)
    reach_l = torch.where(widen, pos - before, float("inf"))
    reach_r = torch.where(widen, pos + after, -float("inf"))
    suf_min = torch.cummin(reach_l.flip(0), 0).values.flip(0)
    pre_max = torch.cummax(reach_r, 0).values
    cleared = flagged | (suf_min <= pos) | (pre_max >= pos)
    weak2 = torch.where(cleared[:, None], 0.0, weak)
    pwr2 = torch.where(cleared, 0.0, pwr)
    return weak2, pwr2, cleared.sum().to(torch.int32)


def despiked_mean(pwr: torch.Tensor) -> torch.Tensor:
    """Mean power excluding pulse outliers: mean, then the mean of the
    samples below 4x that mean (buf.c:336-346 semantics)."""
    keep = pwr <= 4.0 * pwr.mean()
    return (torch.where(keep, pwr, 0.0).sum()
            / torch.clamp(keep.sum(), min=1))


def update_noise_floor(state: BlankerState, pwr: torch.Tensor,
                       step_seconds: float) -> BlankerState:
    """~1 s time-constant despiked noise tracker (buf.c:336-346)."""
    alpha = _f32(min(1.0, step_seconds))
    nf = state.noise_floor * (1.0 - alpha) + despiked_mean(pwr) * alpha
    return BlankerState(noise_floor=torch.clamp(nf, min=1e-20))
