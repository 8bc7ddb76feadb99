"""Noise blankers on the weak timf2 channel (port of
linrad_tpu/ops/blanker.py, reference ``first_noise_blanker``
blank1.c:684-1603).

Clever blanker: fit-and-subtract the strongest candidate pulse against a
bank of fractionally shifted reference pulses (blank1.c:36-232), up to
``max_pulses`` times in sequence.  Stupid blanker: hard-clear every run
above threshold, widened by the sqrt(peak/noise)/100 rule
(blank1.c:1013-1083).

The blocked search's fit loop (the flagship's, and every preset's) is
:func:`blanker_fits`: on a CUDA tensor one launch of the hand-written
kernel in ``csrc/blanker_fits.cu``, which runs every fit inside the
kernel as XLA runs the JAX package's ``fori_loop`` on the device; on a
CPU tensor its plain version :func:`_blanker_fits_reference`, which runs
``max_pulses`` iterations of small tensor operations.  There is no
fallback between the two.  It is a PyTorch custom operator with a rule
for ``torch.func.vmap``: a fleet of R receivers makes one launch of R
blocks.

The flat search (``block_size=0``, a cross-check that no preset selects)
and the round-parallel variant (``rounds>0``, which fits every locally
dominant block's strongest candidate at once, ``rounds`` times) stay in
PyTorch: their loops run on device tensors, every dynamic position an
index tensor, so they never wait for the host, and ``torch.func.vmap``
batches their in-place ``index_put_``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import Geometry
from ..utils import cuda_build
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


# ---- the sequential fits: the kernel's wrapper and its plain version ----

FITS_WINDOW = 256       # most samples in a fit window (pul x C): 8 a lane
# launches of csrc/blanker_fits.cu, made and recorded into CUDA graphs
fits_count = cuda_build.LaunchCount()


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


def _check_fits(wpad, ppad, candp, bmax, refbank, phasefunc, thr, pw,
                max_pulses, lead, s) -> None:
    """Refuse the arguments :func:`blanker_fits` does not take: wpad (T, C)
    complex64; ppad and candp (T,) float32; bmax float32, T a whole number
    of its blocks, two at least; refbank (nref, pul) and phasefunc (pul,)
    complex64 with pul C <= FITS_WINDOW; 0 <= pw < pul / 2 and pul + 2 pw
    + 1 under the block; thr a 0-dim float32; rows lead:lead + s inside T;
    every tensor on one device.

    Not checked, since it would read the data: candp must be
    ``where(active, ppad, -1)`` of a ppad that is nowhere negative (NaN
    allowed), and bmax its block maxima, as :func:`_clever_blanker_blocked`
    builds them.  The plain version searches candp and bmax as given; the
    kernel reads candp only by its sign and bmax only by its length, so on
    other arguments the two differ."""
    if wpad.dim() != 2 or wpad.dtype != torch.complex64:
        raise ValueError(f"blanker_fits: wpad must be (T, C) complex64, got "
                         f"{tuple(wpad.shape)} {wpad.dtype}")
    total, c = wpad.shape
    for name, x in (("ppad", ppad), ("candp", candp)):
        if x.dtype != torch.float32 or tuple(x.shape) != (total,):
            raise ValueError(f"blanker_fits: {name} must be ({total},) "
                             f"float32, got {tuple(x.shape)} {x.dtype}")
    if bmax.dtype != torch.float32 or bmax.dim() != 1 \
            or bmax.shape[0] < 2 or total % bmax.shape[0]:
        raise ValueError(f"blanker_fits: bmax {tuple(bmax.shape)} "
                         f"{bmax.dtype} is not float32 block maxima of "
                         f"{total} samples")
    if refbank.dim() != 2 or refbank.dtype != torch.complex64 \
            or phasefunc.dtype != torch.complex64 \
            or tuple(phasefunc.shape) != (refbank.shape[1],):
        raise ValueError(f"blanker_fits: refbank {tuple(refbank.shape)} / "
                         f"phasefunc {tuple(phasefunc.shape)} must be "
                         f"complex64 (nref, pul) / (pul,)")
    if thr.dtype != torch.float32 or thr.dim() != 0:
        raise ValueError("blanker_fits: thr must be a 0-dim float32 tensor")
    pul = refbank.shape[1]
    blk = total // bmax.shape[0]
    if pul * c > FITS_WINDOW or not 0 <= pw < pul // 2 \
            or not pul + 2 * pw + 1 < blk or max_pulses < 0 \
            or lead < 0 or s < 0 or lead + s > total:
        raise ValueError(f"blanker_fits: unsupported pulse {pul}, width "
                         f"{pw}, channels {c}, block {blk}, max_pulses "
                         f"{max_pulses} or rows {lead}:{lead + s} of "
                         f"{total}")
    devices = {x.device for x in (wpad, ppad, candp, bmax, refbank,
                                  phasefunc, thr)}
    if len(devices) != 1:
        raise ValueError(f"blanker_fits: tensors on different devices "
                         f"{sorted(map(str, devices))}")
    # meta: the fake tensors of a trace, which reach only the fake
    if wpad.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"blanker_fits: unsupported device {wpad.device}")


@functools.lru_cache(maxsize=1)
def _fits_lib():
    """The library of csrc/blanker_fits.cu, built at first use, its C
    functions typed."""
    lib, _info = cuda_build.build("blanker_fits")
    lib.lrt_blanker_fits.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_longlong] * 3
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
    lib.lrt_blanker_fits_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.lrt_blanker_fits_scratch_words.argtypes = [ctypes.c_int]
    return lib


def fits_plan(total: int, c: int, pul: int, nref: int) -> dict:
    """How the kernel holds a stream of ``total`` samples of ``c``
    channels on the current card: the pulse bank in shared memory or read
    from L2, the sub-block width W of its index, and its dynamic shared
    memory in bytes."""
    out = (ctypes.c_int * 3)()
    err = _fits_lib().lrt_blanker_fits_plan(total, c, pul, nref, out)
    if err:
        raise RuntimeError(f"blanker_fits: no shared-memory plan for "
                           f"{total} samples x {c} (CUDA error {err})")
    return {"bank_shared": bool(out[0]), "sub_block": out[1],
            "shared_bytes": out[2]}


def _fits_launch(wpad, ppad, candp, blk: int, refbank, phasefunc, thr,
                 shared: tuple, pw: int, max_pulses: int, lead: int, s: int):
    """One call for R streams: wpad (R, T, C), ppad and candp (R, T),
    blocks of blk samples; refbank, phasefunc and thr with a leading
    stream axis of R, or without it where ``shared`` (three flags) says
    they serve every stream.  The C function launches the prep kernel
    (the working copies, the candidates' index) and the fits kernel.
    Returns (weak (R, S, C), pwr (R, S), nfit (R,))."""
    lib = _fits_lib()
    dev = wpad.device
    r, total, c = wpad.shape
    nref, pul = refbank.shape[-2:]
    wpad, ppad, candp, refbank, phasefunc, thr = (
        x.contiguous() for x in (wpad, ppad, candp, refbank, phasefunc, thr))
    wk = torch.empty((r, total, c), dtype=torch.complex64, device=dev)
    pk = torch.empty((r, total), dtype=torch.float32, device=dev)
    scr = torch.empty(r * lib.lrt_blanker_fits_scratch_words(total),
                      dtype=torch.int32, device=dev)
    nfit = torch.empty(r, dtype=torch.int32, device=dev)
    strides = [0 if sh else x[0].numel()
               for sh, x in zip(shared, (refbank, phasefunc, thr))]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    cuda_build.launch(lib.lrt_blanker_fits, (
        wpad.data_ptr(), ppad.data_ptr(), candp.data_ptr(), wk.data_ptr(),
        pk.data_ptr(), scr.data_ptr(), refbank.data_ptr(),
        phasefunc.data_ptr(), thr.data_ptr(), nfit.data_ptr(), *strides,
        total, c, blk, pul, nref, pw, max_pulses, r, stream), dev,
        f"blanker_fits at ({r}, {total}, {c})")
    fits_count.add()
    return wk[:, lead: lead + s], pk[:, lead: lead + s], nfit


@torch.library.custom_op("linrad_tpu_torch::blanker_fits", mutates_args=())
def blanker_fits(wpad: torch.Tensor, ppad: torch.Tensor, candp: torch.Tensor,
                 bmax: torch.Tensor, refbank: torch.Tensor,
                 phasefunc: torch.Tensor, thr: torch.Tensor, pw: int,
                 max_pulses: int, lead: int,
                 s: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blocked clever blanker's sequential fits.

    wpad (T, C) complex64, ppad (T,) float32: the stream and its power,
    padded to T samples, a whole number of blocks; candp (T,) float32:
    the power where a candidate centre may lie, -1 elsewhere; bmax
    (T / block,) float32: its block maxima; refbank (nref, pul) and
    phasefunc (pul,) complex64: the blanker's tables; thr: the 0-dim
    float32 threshold on the device; pw: the pulse width; up to
    ``max_pulses`` fits.  Returns (weak (S, C), pwr (S,): rows
    ``lead:lead + s`` after the fits, fitted count (0-dim int32)).  No
    argument is changed.

    candp and bmax are what :func:`_clever_blanker_blocked` builds:
    ``where(active, ppad, -1)`` of a power that is not negative, and its
    block maxima.  The plain version searches them; the kernel builds its
    own index of the candidates from candp (an active bit where it is not
    negative, and maxima of 32-sample sub-blocks), which holds the same
    candidates at every fit, and reads only bmax's length.

    A PyTorch custom operator (``torch.ops.linrad_tpu_torch.blanker_fits``)
    with a rule for ``torch.func.vmap``: R streams make one launch of R
    blocks (:func:`_blanker_fits_vmap`).  Its launches are counted in
    ``fits_count``."""
    _check_fits(wpad, ppad, candp, bmax, refbank, phasefunc, thr, pw,
                max_pulses, lead, s)
    if wpad.device.type == "cpu":
        return _blanker_fits_reference(wpad, ppad, candp, bmax, refbank,
                                       phasefunc, thr, pw, max_pulses, lead,
                                       s)
    weak, pwr, nfit = _fits_launch(
        wpad[None], ppad[None], candp[None], wpad.shape[0] // bmax.shape[0],
        refbank, phasefunc, thr, (True, True, True), pw, max_pulses, lead, s)
    return weak[0], pwr[0], nfit[0]


@blanker_fits.register_fake
def _blanker_fits_fake(wpad, ppad, candp, bmax, refbank, phasefunc, thr, pw,
                       max_pulses, lead, s):
    _check_fits(wpad, ppad, candp, bmax, refbank, phasefunc, thr, pw,
                max_pulses, lead, s)
    # rows lead:lead + s of the padded copies, as the real outputs are
    return (wpad.new_empty(wpad.shape)[lead: lead + s],
            ppad.new_empty(ppad.shape)[lead: lead + s],
            ppad.new_empty((), dtype=torch.int32))


@blanker_fits.register_vmap
def _blanker_fits_vmap(info, in_dims, wpad, ppad, candp, bmax, refbank,
                       phasefunc, thr, pw, max_pulses, lead, s):
    """R streams: on the card one launch of R blocks, each stream's own
    arrays and threshold, the tables per stream or shared; on the CPU the
    plain version once per stream."""
    r = info.batch_size

    def lead_axis(x, dim):
        return x.movedim(dim, 0) if dim is not None \
            else x.expand((r,) + tuple(x.shape))

    data = [lead_axis(x, d) for x, d in zip((wpad, ppad, candp, bmax),
                                            in_dims[:4])]
    tabs = [x.movedim(d, 0) if d is not None else x
            for x, d in zip((refbank, phasefunc, thr), in_dims[4:7])]
    shared = tuple(d is None for d in in_dims[4:7])
    _check_fits(*(x[0] for x in data),
                *(t if h else t[0] for t, h in zip(tabs, shared)), pw,
                max_pulses, lead, s)
    if wpad.device.type == "cpu":
        outs = [_blanker_fits_reference(
            *(x[i] for x in data),
            *(t if h else t[i] for t, h in zip(tabs, shared)), pw,
            max_pulses, lead, s) for i in range(r)]
        return tuple(torch.stack(v) for v in zip(*outs)), (0, 0, 0)
    blk = data[0].shape[1] // data[3].shape[1]
    return _fits_launch(*data[:3], blk, *tabs, shared, pw, max_pulses, lead,
                        s), (0, 0, 0)


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
