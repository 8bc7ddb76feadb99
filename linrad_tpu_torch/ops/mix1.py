"""First mixer / decimator — frequency-domain downconversion (port of
linrad_tpu/ops/mix1.py, reference ``do_mix1`` mix1.c:55-647).

``mix1.size`` bins around the tuned bin are taken from each fftx
transform, weighted by the erfc window ``mix1_fqwin``, inverse
transformed at 1/decimation size and overlap-added into the timf3
baseband stream.  The per-frame rotation is tracked as an integer phase
index (c*H mod N), so there is no drift; the tuned bin is a tensor, so
retuning changes no shape.

The fractional-bin ramp, :func:`frac_ramp`, is the custom operator
:func:`mix1_ramp`: on a CUDA tensor one launch of the hand-written kernel
in ``csrc/mix1_ramp.cu`` for every row (R streams under
``torch.func.vmap`` too), on a CPU tensor its plain version
:func:`_frac_ramp_reference`, the sums in XLA's CPU order as small tensor
operations.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy.special import erfc

from ..geometry import Geometry
from ..utils import cuda_build
from ..utils.fporder import ordered_cumsum, ordered_sum
from .framing import overlap_add
from .windows import synthesis_weights


def fqwin_weight(bin_offset: np.ndarray, mix1_size: int) -> np.ndarray:
    """Copy of linrad_tpu.ops.mix1.fqwin_weight: the mix1_fqwin erfc
    taper (make_window mode 5, fft0.c:818-829) at (possibly fractional)
    bin offset from the band centre: win[M/2 - max(|d|, 1)]."""
    m = mix1_size
    d = np.abs(bin_offset)
    return 0.5 * erfc(3.2 - 13.0 * (m // 2 - np.maximum(d, 1.0)) / m)


def _signed_bins(m: int) -> np.ndarray:
    """0..m/2-1, -m/2..-1: small-FFT bin -> offset from the centre."""
    return np.where(np.arange(m) < m // 2, np.arange(m), np.arange(m) - m)


def signed_bins(m: int, device) -> torch.Tensor:
    """_signed_bins made on the device (no host-to-device copy)."""
    k = torch.arange(m, device=device)
    return torch.where(k < m // 2, k, k - m)


@dataclass(frozen=True)
class Mix1Tables:
    fqwin: torch.Tensor  # (M,) float32, FFT-shifted order
    syn: torch.Tensor    # (M,) float32 overlap-add synthesis weights

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix1Tables":
        m = geo.mix1_size
        fqwin = fqwin_weight(_signed_bins(m), m)
        sinpow = geo.fft2_sinpow if geo.second_fft_enable else geo.fft1_sinpow
        syn = synthesis_weights(m, geo.mix1_interleave_points, sinpow)
        return cls(fqwin=torch.as_tensor(fqwin, dtype=torch.float32,
                                         device=device),
                   syn=torch.as_tensor(syn, dtype=torch.float32,
                                       device=device))


@dataclass
class Mix1State:
    """One sub-receiver's mixer state; the multi-receiver step stacks K of
    them on a leading axis."""

    phase_idx: torch.Tensor   # (...,) int32 — phase in units of 1/N turn
    ola_carry: torch.Tensor   # (..., mix1_interleave, C) complex64
    frac_phase: torch.Tensor  # (...,) float32 — fractional-tune phase, turns

    @classmethod
    def create(cls, geo: Geometry, device) -> "Mix1State":
        return cls(
            phase_idx=torch.zeros((), dtype=torch.int32, device=device),
            ola_carry=torch.zeros((geo.mix1_interleave_points, geo.channels),
                                  dtype=torch.complex64, device=device),
            frac_phase=torch.zeros((), dtype=torch.float32, device=device))


def mix1_step(geo: Geometry, tables: Mix1Tables, state: Mix1State,
              spectra: torch.Tensor, center_bins: torch.Tensor, *,
              tune_frac: torch.Tensor | None = None,
              tune_slope: torch.Tensor | None = None
              ) -> tuple[Mix1State, torch.Tensor]:
    """Downconvert one step of fftx spectra to the timf3 stream.

    spectra: (n, N, C) complex64 fftx transforms at hop H samples, shared
    by every sub-receiver; center_bins: () or (n,) integer tuned bin(s)
    (per frame on the AFC path, do_mix1_afc mix1.c:648); tune_frac:
    optional () or (n,) float32 fractional bin offset (set_mix1_phases
    mix1.c:781-860); tune_slope: optional () or (n,) float32 frequency
    change across each frame in big-FFT bins per hop, which linearises AFC
    drift within a frame (requires tune_frac).  Both are keyword-only:
    the JAX version's sixth parameter is the inverse FFT's variant,
    which no caller passes and the port does not take.

    With a state stacked on leading axes (K sub-receivers), center_bins,
    tune_frac and tune_slope are (K, 1) or (K, n): the frame axis is
    always the last.

    Returns (new_state, timf3 (..., n * mix1_new_points, C) complex64)."""
    if tune_slope is not None and tune_frac is None:
        raise ValueError("tune_slope requires tune_frac (the slope "
                         "linearises the fractional-bin ramp)")
    n, big_n, c = spectra.shape
    m = geo.mix1_size
    hop = geo.fftx_new_points
    dev = spectra.device
    lead = tuple(state.phase_idx.shape)
    center = torch.broadcast_to(center_bins.to(torch.int64), lead + (n,))
    rel = signed_bins(m, dev)
    bins = torch.remainder(center[..., None] + rel, big_n)     # (..., n, M)
    frame = torch.arange(n, device=dev)[:, None]
    sel = spectra[frame, bins]                               # (..., n, M, C)
    sel = sel * tables.fqwin[:, None]
    y = torch.fft.ifft(sel, dim=-2) * (m / big_n)

    # Integer phase bookkeeping: frame b is rotated by exp(-2 pi i phi_b/N)
    # with phi advancing by c_b*H (mod N) per frame.  The JAX version
    # wraps in uint32; int64 with & (N-1) gives the same residues exactly
    # for power-of-two N.
    mask = big_n - 1
    incr = (center * hop) & mask
    cum = torch.cumsum(incr, -1) - incr  # exclusive prefix
    phase0 = state.phase_idx.to(torch.int64)
    idx = (phase0[..., None] + cum) & mask
    theta = (-2.0 * math.pi / big_n) * idx.to(torch.float32)
    y = y * torch.complex(torch.cos(theta), torch.sin(theta))[..., None, None]
    new_phase = ((phase0 + incr.sum(-1)) & mask).to(torch.int32)

    timf3, carry = overlap_add(y * tables.syn[:, None],
                               geo.mix1_new_points, state.ola_carry)
    new_frac = state.frac_phase
    if tune_frac is not None:
        ramp, new_frac = frac_ramp(geo, state.frac_phase, tune_frac,
                                   tune_slope, n)
        timf3 = timf3 * ramp[..., None]
    return Mix1State(phase_idx=new_phase, ola_carry=carry,
                     frac_phase=new_frac), timf3


def frac_ramp(geo: Geometry, frac_phase: torch.Tensor,
              tune_frac: torch.Tensor, tune_slope: torch.Tensor | None,
              n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-frequency ramp on the timf3 output: frac big-FFT bins ==
    frac/m turns per timf3 sample (mix1.c:141-234).  With tune_slope the
    frequency is linear within each frame: frac is its value at the frame
    midpoint, slope its change per hop.

    frac_phase (...,); tune_frac and tune_slope () or (..., n).  Returns
    (complex64 ramp (..., n*mix1_new_points), final phase in turns).

    :func:`mix1_ramp` with the geometry's sizes: on a CUDA tensor one
    launch of ``csrc/mix1_ramp.cu``, on a CPU tensor
    :func:`_frac_ramp_reference`."""
    return mix1_ramp(frac_phase, tune_frac.to(torch.float32),
                     None if tune_slope is None
                     else tune_slope.to(torch.float32),
                     n, geo.mix1_size, geo.mix1_new_points)


def _frac_ramp_reference(frac_phase: torch.Tensor, tune_frac: torch.Tensor,
                         tune_slope: torch.Tensor | None, n: int, m: int,
                         hop_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mix1_ramp` (``m`` the mix1 size,
    ``hop_m`` its new points a frame).

    The phase is a float32 prefix sum over the step, and its rounding
    reaches the baseband amplified: mix2 divides by the mix1 window, which
    is small at the band edges, and the rounding is white across the band.
    So the sums are taken in the JAX package's order (XLA's CPU order,
    :mod:`..utils.fporder`): in torch's own order the baseband of a 3 kHz
    preset with the dial between bins differed from JAX's by 2.4e-4, as
    far as either is from a float64 ramp."""
    lead = tuple(frac_phase.shape)
    fr = torch.broadcast_to(tune_frac.to(torch.float32), lead + (n,))
    per_samp = torch.repeat_interleave(fr / m, hop_m, dim=-1)
    if tune_slope is not None:
        sl = torch.broadcast_to(tune_slope.to(torch.float32), lead + (n,))
        pos = (torch.arange(hop_m, dtype=torch.float32, device=fr.device)
               + 0.5) / hop_m - 0.5                   # (-0.5, 0.5)
        # XLA's CPU backend contracts this multiply-add into one fused
        # multiply-add, rounded once: formed in float64, rounded once
        per_samp = (per_samp.double() + torch.repeat_interleave(
            sl / m, hop_m, dim=-1).double() * pos.repeat(n).double()
            ).float()
    cum = frac_phase[..., None] + ordered_cumsum(per_samp) - per_samp
    theta = (-2.0 * math.pi) * torch.remainder(cum, 1.0)
    ramp = torch.complex(torch.cos(theta), torch.sin(theta))
    return ramp, torch.remainder(frac_phase + ordered_sum(per_samp), 1.0)


# ---- the ramp on the card: one kernel ----------------------------------

# launches of csrc/mix1_ramp.cu, made and recorded into CUDA graphs
ramp_count = cuda_build.launch_count("mix1_ramp")
RAMP_MAX_LEN = 1 << 19   # samples a row: the levels fit in shared memory
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
RAMP_ARGS = ((_PTR, _LL) + (_PTR, _LL, _LL) * 2 + (_PTR, _PTR)
             + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2 + (_PTR,))
RAMP_CONSTANTS = (("lrt_mix1_ramp_max_len", RAMP_MAX_LEN),)


def _check_ramp(frac_phase, tune_frac, tune_slope, n, m, hop_m) -> None:
    """Refuse what the ramp does not take: float32 tensors, tune_frac and
    tune_slope (where given) broadcastable to frac_phase's shape plus n
    frames, and n, m, hop_m of at least 1."""
    tensors = [frac_phase, tune_frac] + (
        [] if tune_slope is None else [tune_slope])
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"mix1_ramp: frac_phase, tune_frac and tune_slope "
                         f"must be float32, got "
                         f"{[x.dtype for x in tensors]}")
    if n < 1 or m < 1 or hop_m < 1:
        raise ValueError(f"mix1_ramp: n {n}, m {m} and hop_m {hop_m} must "
                         f"be at least 1")
    full = tuple(frac_phase.shape) + (n,)
    for x in tensors[1:]:
        try:
            ok = torch.broadcast_shapes(x.shape, full) == full
        except RuntimeError:
            ok = False
        if not ok:
            raise ValueError(f"mix1_ramp: a fraction or slope of shape "
                             f"{tuple(x.shape)} does not broadcast to "
                             f"{full} (frac_phase's shape and n frames)")


def _per_frame(x: torch.Tensor, full: tuple) -> tuple:
    """x (R, ...), broadcast to ``full`` = (R, *lead, n), as (rows, n) rows
    (a view wherever the strides allow) and its row and frame strides."""
    x = x.reshape((x.shape[0],) + (1,) * (len(full) - x.dim())
                  + tuple(x.shape[1:]))
    x = x.expand(full).reshape(-1, full[-1])
    return x, x.stride(0), x.stride(1)


def _ramp_launch(frac_phase, tune_frac, tune_slope, n, m, hop_m):
    """One launch for R streams, each of any leading axes: frac_phase (R,
    *lead), tune_frac and tune_slope (R, ...) broadcastable to (R, *lead,
    n), one block a row.  Returns (ramp (R, *lead, n hop_m) complex64, new
    phase (R, *lead))."""
    dev = frac_phase.device
    sls = () if tune_slope is None else (tune_slope,)
    if any(x.device != dev for x in (tune_frac, *sls)):
        raise ValueError("mix1_ramp: tensors on different devices")
    length = n * hop_m
    if length > RAMP_MAX_LEN:
        raise ValueError(f"mix1_ramp: the kernel takes at most "
                         f"{RAMP_MAX_LEN} samples a row, got {length}")
    full = tuple(frac_phase.shape) + (n,)
    fp = frac_phase.reshape(-1)
    rows = fp.shape[0]
    ramp = torch.empty((rows, length), dtype=torch.complex64, device=dev)
    phase = torch.empty(rows, dtype=torch.float32, device=dev)
    fr, fr_r, fr_f = _per_frame(tune_frac, full)
    sl, sl_r, sl_f = _per_frame(tune_slope, full) if sls else (None, 0, 0)
    # a Python scalar divisor is its float reciprocal's product on the card
    f32 = np.float32
    cuda_build.launch(
        cuda_build.bind("mix1_ramp", "lrt_mix1_ramp", RAMP_ARGS,
                        expect=RAMP_CONSTANTS), (
            fp.data_ptr(), fp.stride(0), fr.data_ptr(), fr_r, fr_f,
            None if sl is None else sl.data_ptr(), sl_r, sl_f,
            ramp.data_ptr(), phase.data_ptr(), rows, n, hop_m,
            float(f32(1) / f32(m)), float(f32(1) / f32(hop_m))), dev,
        f"mix1_ramp at ({rows}, {length})", ramp_count)
    return ramp.reshape(full[:-1] + (length,)), phase.reshape(full[:-1])


_ramp = cuda_build.Streams("mix1_ramp", _check_ramp, _frac_ramp_reference,
                           _ramp_launch)


@torch.library.custom_op("linrad_tpu_torch::mix1_ramp", mutates_args=())
def mix1_ramp(frac_phase: torch.Tensor, tune_frac: torch.Tensor,
              tune_slope: Optional[torch.Tensor], n: int, m: int,
              hop_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """mix1's fractional-bin ramp over n frames of hop_m timf3 samples, at
    tune_frac bins of an m-point mix1 (with tune_slope, linear in each
    frame), from the phase frac_phase (turns).  frac_phase (...,) float32;
    tune_frac and tune_slope float32, broadcastable to (..., n).  Returns
    (ramp (..., n hop_m) complex64, the new phase (...,)); no argument is
    changed.

    A PyTorch custom operator (``torch.ops.linrad_tpu_torch.mix1_ramp``)
    with a rule for ``torch.func.vmap``: on a CUDA tensor one launch of
    ``csrc/mix1_ramp.cu`` for every row of every stream, bit for bit the
    plain version's on the card; on a CPU tensor
    :func:`_frac_ramp_reference`.  Its launches are counted in
    ``ramp_count``."""
    return _ramp(frac_phase, tune_frac, tune_slope, n, m, hop_m)


@mix1_ramp.register_fake
def _mix1_ramp_fake(frac_phase, tune_frac, tune_slope, n, m, hop_m):
    _check_ramp(frac_phase, tune_frac, tune_slope, n, m, hop_m)
    return (frac_phase.new_empty(tuple(frac_phase.shape) + (n * hop_m,),
                                 dtype=torch.complex64),
            torch.empty_like(frac_phase))


mix1_ramp.register_vmap(_ramp.vmap)
