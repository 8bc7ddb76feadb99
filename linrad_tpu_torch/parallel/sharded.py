"""Time-block sharded pipeline step (port of linrad_tpu/parallel/sharded.py).

The wideband hot path (fft1 -> sellim split -> back-FFT -> blankers ->
fft2 -> mix1) is split along the time axis: shard d processes the d-th
contiguous slice of each step's samples.  The cross-shard dependencies
are all between neighbours or over every shard, carried by the group's
collectives (:mod:`.group`):

1. **Framing halos**: overlapped analysis frames need the previous
   shard's tail samples (``_shard_tail``).
2. **Overlap-add carries**: inverse-transform reconstruction pushes
   partial sums into the next shard (``_shard_ola``, the timf3 carry).
3. **Reductions**: power-spectrum averages and the blanker's noise floor
   are means over every shard; the blanker counts are sums.

The decimated narrowband finale (fft3, mix2, detector, AGC) runs once per
process on the gathered timf3 stream, through the same
``pipeline.chain.narrowband_post_mix1`` as the single-device step, and the
carried state is one replicated copy on the group's home device, updated
from the last shard's values.  This is the form of Linrad's master and
slaves on one signal (z_NETWORK.txt): one stream over several cards.

On one card (``["cuda:0"] * d``) every shard runs on that card: the halo,
carry and reduction logic runs as on several, with no traffic between
cards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Geometry, derive_geometry
from ..ops import blanker as blanker_ops
from ..ops import fft as fftlib
from ..ops import sellim as sellim_ops
from ..ops.blanker import BlankerState, _f32
from ..ops.fft1 import FFT1State, fft1_step
from ..ops.fft2 import FFT2State
from ..ops.framing import frame_stream, overlap_add
from ..ops.mix1 import Mix1State, frac_ramp, mix1_step
from ..ops.timf2 import Timf2State
from ..params import RxParams
from ..pipeline.batch import BatchRunner
from ..pipeline.chain import (NBState, RxOutputs, RxState, RxTables,
                              narrowband_post_mix1)
from ..pipeline.control import WeakSignalControl
from ..pipeline.receiver import (GraphedReceiver, MultiState, PairedState,
                                 _as_block, _block_dtype, _block_rows,
                                 _owned, _pulsewidth, _tuning_args,
                                 pair_step, resolve_device,
                                 tuning_structures)
from ..weak.spur import spur_subtract_step
from .group import LocalGroup


def _shard_tail(group, state_tail: torch.Tensor, blocks: list
                ) -> tuple[list, torch.Tensor]:
    """Per-shard framing tails: the left neighbour's chunk end, or the
    carried state tail on shard 0.  Returns (tails, new_state_tail)."""
    ov = state_tail.shape[0]
    ends = [b[b.shape[0] - ov:] for b in blocks]
    left = group.from_left(ends)
    tails = [state_tail.to(dev) if group.axis_index(i) == 0 else left[i]
             for i, dev in enumerate(group.devices)]
    return tails, group.pick_last(ends)


def _add_head(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x with ``head`` added to its first rows (the sample axis is the last
    but one)."""
    ov = head.shape[-2]
    return torch.cat([x[..., :ov, :] + head, x[..., ov:, :]], dim=-2)


def _shard_ola(group, frames: list, hop: int, state_carry: torch.Tensor
               ) -> tuple[list, torch.Tensor]:
    """Sharded overlap-add: local OLA, then the trailing partial sums go
    into the right neighbour's head (carry chain); shard 0 takes the
    carried state."""
    outs, carries = [], []
    for f in frames:
        out, carry = overlap_add(f, hop, torch.zeros_like(
            state_carry, device=f.device))
        outs.append(out)
        carries.append(carry)
    incoming = group.from_left(carries)
    outs = [_add_head(out, state_carry.to(out.device)
                      if group.axis_index(i) == 0 else incoming[i])
            for i, out in enumerate(outs)]
    return outs, group.pick_last(carries)


def _extend(group, xs: list, halo: int) -> list:
    """Each shard's stream with ``halo`` samples of each neighbour (zeros
    at the ends)."""
    left = group.from_left([x[x.shape[0] - halo:] for x in xs])
    right = group.from_right([x[:halo] for x in xs])
    return [torch.cat([a, x, b]) for a, x, b in zip(left, xs, right)]


def _power(x: torch.Tensor) -> torch.Tensor:
    """Channel-summed power of a (S, C) complex stream."""
    return (x.real ** 2 + x.imag ** 2).sum(-1)


def _sharded_blankers(group, p: RxParams, tables_l: list, weak: list,
                      wpwr: list, nf: torch.Tensor, pulsewidth: int):
    """The clever blanker with cross-shard halos: each shard sees one
    fit window of neighbour samples, so boundary pulses are fitted whole;
    candidate centres stay shard-owned (``eligible``), and the corrections
    a fit writes into a neighbour's samples are shipped back to it and
    added (subtractions are linear, so they compose).  Then the stupid
    blanker on halo-extended streams (its widening reaches no further than
    pulsewidth + 1 < halo, so runs across a shard edge widen as on one
    device).  Returns (weak, wpwr, fitted per shard, cleared per shard)."""
    halo = tables_l[0].blanker.refbank.shape[1]
    rows = weak[0].shape[0]
    max_fits = max(1, p.max_pulses_per_block // group.axis_size)
    nf_l = group.replicate(nf)
    ext_w = _extend(group, weak, halo)
    ext_p = _extend(group, wpwr, halo)
    fitted, to_left, to_right = [], [], []
    for i, dev in enumerate(group.devices):
        elig = torch.zeros(rows + 2 * halo, dtype=torch.bool, device=dev)
        elig[halo: halo + rows] = True
        w2, _p2, n_fit = blanker_ops.clever_blanker(
            ext_w[i], ext_p[i], tables_l[i].blanker, nf_l[i],
            p.clever_bln_limit, pulsewidth, max_fits,
            block_size=p.blanker_block_size, rounds=p.blanker_rounds,
            eligible=elig)
        weak[i] = w2[halo: halo + rows]
        to_left.append(w2[:halo] - ext_w[i][:halo])
        to_right.append(w2[w2.shape[0] - halo:] - ext_w[i][ext_w[i].shape[0]
                                                           - halo:])
        fitted.append(n_fit)
    add_r = group.from_right(to_left)     # this shard's tail samples
    add_l = group.from_left(to_right)     # this shard's head samples
    for i in range(len(weak)):
        w = torch.cat([weak[i][:rows - halo], weak[i][rows - halo:]
                       + add_r[i]])
        weak[i] = torch.cat([w[:halo] + add_l[i], w[halo:]])
        wpwr[i] = _power(weak[i])
    sw = _extend(group, weak, halo)
    sp = _extend(group, wpwr, halo)
    cleared = []
    for i in range(len(weak)):
        sw2, sp2, _ = blanker_ops.stupid_blanker(
            sw[i], sp[i], nf_l[i], p.stupid_bln_limit, pulsewidth)
        pre = wpwr[i]
        weak[i] = sw2[halo: halo + rows]
        wpwr[i] = sp2[halo: halo + rows]
        cleared.append(((wpwr[i] == 0.0) & (pre > 0.0)).sum()
                       .to(torch.int32))
    return weak, wpwr, fitted, cleared


def _sharded_spur(group, geo: Geometry, tables: RxTables, state, fftx: list,
                  n_fftx_local: int):
    """Spur cancellation on the gathered spectra (the per-frame model
    recurrence chains across shard edges), then each shard's frames."""
    full = group.all_gather(fftx, dim=0)
    s_spur, clean = spur_subtract_step(geo, tables.spur_template, state,
                                       full)
    return s_spur, group.scatter(clean, 0)


def _sharded_front(group, geo: Geometry, p: RxParams, pulsewidth: int,
                   tables: RxTables, tables_l: list, state: RxState,
                   blocks: list, tune0: torch.Tensor, n_fftx_local: int):
    """Sharded fft1 -> sellim -> back-FFT -> blankers -> fft2 -> spur, the
    shard-aware twin of chain._wideband_front.  Returns (wide states,
    per-shard fftx spectra, aux)."""
    step_seconds = geo.samples_per_step / geo.timf1_sampling_speed
    # fft1: the shared stage; tails from the left neighbour, the power
    # statistics averaged over every shard
    tails, new_tail = _shard_tail(group, state.fft1.tail, blocks)
    s1, specs, step_power = fft1_step(
        geo, [t.fft1 for t in tables_l],
        FFT1State(tail=tails, sumsq_avg=state.fft1.sumsq_avg), blocks,
        p.fft_avg1num, reduce=group.pmean)
    sumsq = s1.sumsq_avg
    wide = dict(fft1=FFT1State(tail=new_tail, sumsq_avg=sumsq),
                sellim=state.sellim, timf2=state.timf2, fft2=state.fft2,
                blanker=state.blanker, spur=state.spur)
    aux = dict(step_power=step_power, fft2_power=None, liminfo=None,
               blanker_fitted=None, blanker_cleared=None, noise_floor=None,
               sumsq=sumsq)
    if not geo.second_fft_enable:
        fftx = specs
        if p.spur_enable:
            wide["spur"], fftx = _sharded_spur(group, geo, tables,
                                               state.spur, fftx, n_fftx_local)
        return wide, fftx, aux
    # protected passband (selfreq_liminfo, sellim.c:38-116), replicated
    sel_c = torch.div(tune0, geo.fft2_size // geo.fft1_size,
                      rounding_mode="floor")
    bw_bins = max(1, int(0.7 * (p.filter_high_hz - p.filter_low_hz)
                         / geo.fft1_bandwidth)) + 3
    s_sellim = sellim_ops.update_liminfo(
        geo, state.sellim, sumsq.sum(-1), p.sellim_maxlevel,
        ston=p.sellim_ston, sel_lo=sel_c - bw_bins, sel_hi=sel_c + bw_bins)
    gains = group.replicate(torch.stack(
        sellim_ops.liminfo_gains(s_sellim.liminfo)))
    # back transform of the local frames; OLA with the carry chain
    back = [fftlib.ifft(spec[None] * g[:, None, :, None], axis=2)
            * t.timf2_syn[None, None, :, None]
            for spec, g, t in zip(specs, gains, tables_l)]
    hop = geo.fft1_new_points
    weak, wc = _shard_ola(group, [b[0] for b in back], hop,
                          state.timf2.weak_carry)
    strong, sc = _shard_ola(group, [b[1] for b in back], hop,
                            state.timf2.strong_carry)
    wpwr = [_power(w) for w in weak]
    # the floor follows the PRE-blank power, as chain.py's does
    nf = state.blanker.noise_floor
    mean = group.pmean([blanker_ops.despiked_mean(x) for x in wpwr])
    a_nf = _f32(min(1.0, step_seconds))
    s_blank = BlankerState(noise_floor=torch.clamp(
        nf * (1.0 - a_nf) + mean * a_nf, min=1e-20))
    n_fit = n_clear = torch.zeros((), dtype=torch.int32, device=group.home)
    if p.blanker_enable:
        weak, wpwr, fitted, cleared = _sharded_blankers(
            group, p, tables_l, weak, wpwr, nf, pulsewidth)
        n_fit = group.psum(fitted)
        n_clear = group.psum(cleared)
    # fft2 framing over the sharded timf2 stream
    timf2 = [w + s for w, s in zip(weak, strong)]
    tails2, new_tail2 = _shard_tail(group, state.fft2.tail, timf2)
    fftx = [fftlib.fft(frame_stream(tl, x, geo.fft2_size,
                                    geo.fft2_new_points)[0]
                       * t.fft2.window[None, :, None], axis=1)
            for tl, x, t in zip(tails2, timf2, tables_l)]
    if p.spur_enable:
        # before the power spectrum, as the single-device chain does
        wide["spur"], fftx = _sharded_spur(group, geo, tables, state.spur,
                                           fftx, n_fftx_local)
    fft2_power = group.pmean([(x.real ** 2 + x.imag ** 2).mean(0)
                              for x in fftx])
    a2 = min(1.0, geo.fft2_frames_per_step / max(p.fft_avg1num, 1))
    wide.update(sellim=s_sellim, timf2=Timf2State(weak_carry=wc,
                                                  strong_carry=sc),
                fft2=FFT2State(tail=new_tail2, sumsq_avg=state.fft2.sumsq_avg
                               * (1 - a2) + fft2_power * a2),
                blanker=s_blank)
    aux.update(fft2_power=fft2_power, liminfo=s_sellim.liminfo,
               blanker_fitted=n_fit, blanker_cleared=n_clear,
               noise_floor=s_blank.noise_floor)
    return wide, fftx, aux


def _sharded_mix1(group, geo: Geometry, tables_l: list, state: Mix1State,
                  fftx: list, tune_bin: torch.Tensor, per_frame_tune: bool,
                  n_fftx_local: int, tune_frac: torch.Tensor | None = None,
                  tune_slope: torch.Tensor | None = None):
    """mix1 over sharded fftx frames: each shard runs the shared
    ``mix1_step`` from a phase offset equal to the wrapped sum of every
    earlier shard's increments; the timf3 OLA carries chain into the right
    neighbour and the decimated stream is gathered.

    ``state`` may be stacked over K sub-receivers (leading axes), with
    tune_bin (K,); otherwise tune_bin is () or, with ``per_frame_tune``,
    (fftx_frames_per_step,), like tune_frac and tune_slope (the coherent
    AFC's ramps, mix1.c:648): each shard takes its frames' part.  Each
    shard's fractional-phase origin is the exclusive prefix of the
    per-shard frac advances (the slope term sums to zero within a frame).

    Returns (new replicated mix1 state, full timf3)."""
    big_n = geo.fftx_size
    mask = big_n - 1                  # the JAX version wraps in uint32
    hop = geo.fftx_new_points
    lead = tuple(state.phase_idx.shape)
    devs = group.devices
    phase0 = state.phase_idx.to(torch.int64)
    if per_frame_tune:
        tunes = group.scatter(tune_bin, -1)
        sums = group.all_gather([((t.to(torch.int64) * hop) & mask)
                                 .sum()[None] for t in tunes])     # (D,)
        order = torch.arange(sums.shape[0], device=sums.device)
        phases = [(phase0 + torch.where(order < group.axis_index(i), sums, 0)
                   .sum()) & mask for i in range(len(devs))]
    else:
        tunes = group.replicate(tune_bin)
        incr = (tune_bin.to(torch.int64) * hop) & mask
        phases = [(phase0 + incr * (group.axis_index(i) * n_fftx_local))
                  & mask for i in range(len(devs))]
    fracs_l = slopes_l = [None] * len(devs)
    shard_fracs = [state.frac_phase] * len(devs)
    if tune_frac is not None:
        fracs_l = group.scatter(tune_frac, -1)
        slopes_l = (group.scatter(tune_slope, -1) if tune_slope is not None
                    else slopes_l)
        # each frame adds hop_m samples at frac/m turns per sample
        per = geo.mix1_new_points / geo.mix1_size
        advs = group.all_gather([(f.to(torch.float32).sum() * per)[None]
                                 for f in fracs_l])
        order = torch.arange(advs.shape[0], device=advs.device)
        shard_fracs = [torch.remainder(
            state.frac_phase + torch.where(order < group.axis_index(i),
                                           advs, 0.0).sum(), 1.0)
            for i in range(len(devs))]
    ov3 = geo.mix1_interleave_points
    m1s, timf3 = [], []
    for i, dev in enumerate(devs):
        local = Mix1State(phase_idx=phases[i].to(torch.int32).to(dev),
                          ola_carry=torch.zeros_like(state.ola_carry,
                                                     device=dev),
                          frac_phase=shard_fracs[i].to(dev))
        center = tunes[i].reshape(lead + (-1,)) if lead else tunes[i]
        m1, t3 = mix1_step(geo, tables_l[i].mix1, local, fftx[i], center,
                           tune_frac=fracs_l[i], tune_slope=slopes_l[i])
        m1s.append(m1)
        timf3.append(t3)
    incoming = group.from_left([m.ola_carry for m in m1s])
    for i, dev in enumerate(devs):
        head = (state.ola_carry.to(dev) if group.axis_index(i) == 0
                else incoming[i])
        if tune_frac is not None:
            # mix1_step ramps its OLA output; the neighbour's carry is
            # raw, so this shard's output ramp goes onto it here
            ramp, _ = frac_ramp(geo, shard_fracs[i].to(dev), fracs_l[i],
                                slopes_l[i], int(fftx[i].shape[0]))
            head = head * ramp[..., :ov3, None]
        timf3[i] = _add_head(timf3[i], head)
    new_state = Mix1State(
        phase_idx=group.pick_last([m.phase_idx for m in m1s]),
        ola_carry=group.pick_last([m.ola_carry for m in m1s]),
        frac_phase=group.pick_last([m.frac_phase for m in m1s]))
    return new_state, group.all_gather(timf3, dim=-2)


def _fir_len(tables: RxTables) -> int:
    fir = tables.mix2.fir
    return int(fir.shape[0]) if fir is not None else 0


def _outputs(aux: dict, audio, baseb, gain) -> RxOutputs:
    return RxOutputs(audio=audio, baseb=baseb, fft1_power=aux["step_power"],
                     fft1_avg_power=aux["sumsq"], agc_gain=gain,
                     fft2_power=aux["fft2_power"], liminfo=aux["liminfo"],
                     blanker_fitted=aux["blanker_fitted"],
                     blanker_cleared=aux["blanker_cleared"],
                     noise_floor=aux["noise_floor"])


def _check(geo: Geometry, d: int) -> int:
    """Every stage's frames split evenly over d shards; returns the fftx
    frames per shard."""
    counts = [geo.fft1_frames_per_step, geo.fft3_frames_per_step]
    if geo.second_fft_enable:
        counts.append(geo.fft2_frames_per_step)
    if any(c % d for c in counts):
        raise ValueError(f"frames per step {counts} do not split over {d} "
                         f"shards; derive the geometry with "
                         f"RxParams(shards={d})")
    return geo.fftx_frames_per_step // d


class _Placed:
    """The tables on every local shard's device: those the step was built
    with are placed once, any others at each call."""

    def __init__(self, group, tables: RxTables | None):
        self.group = group
        self.tables = tables
        self.local = group.replicate(tables) if tables is not None else None

    def __call__(self, tables: RxTables) -> list:
        if tables is self.tables:
            return self.local
        return self.group.replicate(tables)


def make_sharded_rx_step(geo: Geometry, p: RxParams, group,
                         blanker_pulsewidth: int = 2,
                         per_frame_tune: bool = False,
                         coherent_tune: bool = False,
                         tables: RxTables | None = None):
    """Build the sharded step over ``group`` (:mod:`.group`).  Every
    shard's chunk must hold a whole number of frames at every stage:
    derive the geometry with ``RxParams(shards=<group size>)``.

    Returns ``step(tables, state, blocks, tune_bin, tune_frac=None,
    tune_slope=None) -> (state, outputs)``: ``blocks`` is the list of this
    process's shards' rows of the step (``group.scatter`` of the whole
    block, or ``multihost.scatter_step_block``), each on its shard's
    device; tables, state, tuning and outputs are replicated, on the
    group's home device.  As in the JAX package the plain step tunes to
    an integer bin; ``per_frame_tune`` takes a (fftx_frames_per_step,)
    tune_bin (the AFC's mix1_fq_mid path), each shard its frames' part;
    ``coherent_tune`` also takes per-frame tune_frac and tune_slope (the
    coherent drift tracking, do_mix1_afc mix1.c:648).  ``tables``: the
    tables the step will be called with, placed on the shards' devices
    once here."""
    n_fftx_local = _check(geo, group.axis_size)
    placed = _Placed(group, tables)
    frame_tuned = per_frame_tune or coherent_tune

    def step(tables: RxTables, state: RxState, blocks: list,
             tune_bin: torch.Tensor, tune_frac: torch.Tensor | None = None,
             tune_slope: torch.Tensor | None = None):
        # the global first frame's bin
        tune0 = tune_bin.reshape(-1)[0] if frame_tuned else tune_bin
        tables_l = placed(tables)
        wide, fftx, aux = _sharded_front(
            group, geo, p, blanker_pulsewidth, tables, tables_l, state,
            blocks, tune0, n_fftx_local)
        new_mix1, timf3 = _sharded_mix1(
            group, geo, tables_l, state.mix1, fftx, tune_bin, frame_tuned,
            n_fftx_local, tune_frac=tune_frac if coherent_tune else None,
            tune_slope=tune_slope if coherent_tune else None)
        # the narrowband finale, once per process (1/decimation of the
        # data), shared with the single-device chain
        nb, audio, baseb, gain = narrowband_post_mix1(
            geo, p, tables, NBState.from_rx(state), new_mix1, timf3)
        new_state = RxState(**wide, **nb.fields())
        return new_state, _outputs(aux, audio, baseb, gain)

    return step


def make_sharded_multi_rx_step(geo: Geometry, p: RxParams, group,
                               n_subch: int, blanker_pulsewidth: int = 2,
                               tables: RxTables | None = None):
    """The sharded twin of chain.make_multi_rx_step: one sharded wideband
    front end feeding K independently tuned sub-receivers (the
    reference's network userx consumers, globdef.h:1282-1294, served from
    one master's wideband stream).  The K tails run as one set of
    operations on tensors stacked on a leading axis, as in the
    single-device multi step (no vmap).

    Returns ``step(tables, state, nbs, blocks, tune_bins) -> ((state,
    nbs), outputs)``, tune_bins (K,) integer."""
    n_fftx_local = _check(geo, group.axis_size)
    placed = _Placed(group, tables)

    def step(tables: RxTables, state: RxState, nbs: NBState, blocks: list,
             tune_bins: torch.Tensor):
        tune0 = tune_bins.reshape(-1)[0]
        tables_l = placed(tables)
        wide, fftx, aux = _sharded_front(
            group, geo, p, blanker_pulsewidth, tables, tables_l, state,
            blocks, tune0, n_fftx_local)
        m1, timf3 = _sharded_mix1(group, geo, tables_l, nbs.mix1, fftx,
                                  tune_bins, False, n_fftx_local)
        nbs_out, audio, baseb, gain = narrowband_post_mix1(
            geo, p, tables, nbs, m1, timf3)
        new_state = dataclasses.replace(state, **wide)
        return (new_state, nbs_out), _outputs(aux, audio, baseb, gain)

    return step


def shard_group(devices):
    """``devices`` as a shard group: a group passes through; a list of
    devices (one per shard, "cuda:0" may repeat) becomes a
    :class:`.group.LocalGroup`; None means every CUDA device."""
    if devices is not None and not isinstance(devices, (list, tuple)):
        return devices
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sharded receiver: no device list given and "
                               "torch.cuda.is_available() is False")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return LocalGroup([resolve_device(d) for d in devices])


def graph_group(group, graphed: bool | None) -> bool:
    """Whether the sharded step replays from CUDA graphs: ``graphed=None``
    means where every shard is on one CUDA device of a LocalGroup.  A CUDA
    graph belongs to one device, and the step over several devices moves
    data between their streams (a DistGroup: between processes), so
    ``graphed=True`` there raises."""
    one = type(group) is LocalGroup and len(set(group.devices)) == 1
    if graphed and not one:
        raise NotImplementedError(
            "graphed=True: the sharded step over several devices or a "
            "DistGroup runs eagerly; graphing it across cards is queued in "
            "ROADMAP.md, queue 1 item 3")
    return one and group.home.type == "cuda" if graphed is None \
        else bool(graphed)


class _ShardedBase:
    """Group, params with ``shards`` set to the group's size, geometry,
    tables and the blanker's pulse width."""

    def _setup(self, params: RxParams, devices, calibration,
               graphed: bool | None = None) -> bool:
        """Returns whether the step is to replay from CUDA graphs."""
        self.group = shard_group(devices)
        want = graph_group(self.group, graphed)
        self.device = self.group.home
        d = self.group.axis_size
        if params.shards != d:
            params = dataclasses.replace(params, shards=d)
        self.params = params
        self.geo: Geometry = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device,
                                      calibration)
        self.blanker_pulsewidth = _pulsewidth(self.geo)
        return want

    def _shard_rows(self, block) -> list:
        """One step of input as this process's shards' rows: a whole block
        (numpy or tensor) is split; a list (``scatter_step_block``) is
        taken as it is."""
        if isinstance(block, (list, tuple)):
            return list(block)
        return self.group.scatter(_as_block(block, self.geo, self.device), 0)

    def _shard_shapes(self) -> list:
        """The per-shard input shapes of one step, all on one device."""
        d = self.group.axis_size
        return [(_block_rows(self.geo) // d, self.geo.channels)] * d

    def run(self, iq: np.ndarray):
        """Stream a recording; yields RxOutputs per step."""
        if iq.ndim == 1:
            iq = iq[:, None]
        s = _block_rows(self.geo)
        for i in range(iq.shape[0] // s):
            yield self.process_block(iq[i * s:(i + 1) * s])


class ShardedReceiver(_ShardedBase, GraphedReceiver):
    """A receiver running one pipeline over a shard group.

    The host feeds whole step blocks, which are split along time over the
    shards.  This is the single-pipeline scale-out mode (Linrad master and
    slaves on one signal, z_NETWORK.txt); for throughput over independent
    recordings use one Receiver per device, or FleetRunner, instead.

    devices: one device per shard ("cuda:0", "cuda:1", ...; a device may
    repeat, and ``["cpu"] * 4`` runs on the CPU), a group from
    :mod:`.group` or :func:`.multihost.global_time_mesh`, or None for every
    CUDA device.  ``params.shards`` is set to the group's size.

    With every shard on one CUDA device the step replays from CUDA graphs,
    one per tuning structure the parameters can reach, as the JAX
    receiver jits one step per structure; the outputs are the caller's
    copies (``graphed``, ``recorded`` as for ``pipeline.Receiver``).  Over
    several devices or a DistGroup it runs eagerly (``graphed`` False;
    True raises NotImplementedError)."""

    def __init__(self, params: RxParams, devices=None,
                 calibration: dict | None = None, *,
                 graphed: bool | None = None, recorded=None):
        self.graphs = {}
        want = self._setup(params, devices, calibration, graphed)
        geo, params = self.geo, self.params
        self.state = RxState.create(geo, self.device,
                                    spur=params.spur_enable,
                                    pol=params.pol_adapt_enable,
                                    fir_len=_fir_len(self.tables))
        pw = self.blanker_pulsewidth
        self._steps = {
            "bin": make_sharded_rx_step(geo, params, self.group, pw,
                                        tables=self.tables),
            # the AFC's paths: per-frame bins, and the coherent (bins,
            # frac, slope) frames
            "frames": make_sharded_rx_step(
                geo, params, self.group, pw, per_frame_tune=True,
                tables=self.tables),
            "coherent": make_sharded_rx_step(
                geo, params, self.group, pw, coherent_tune=True,
                tables=self.tables)}
        # the one-bin tuning, written in place by tune()
        self._tune0 = (torch.zeros((), dtype=torch.int64, device=self.device),
                       torch.zeros((), dtype=torch.float32,
                                   device=self.device))
        self._tune_bin, self._tune_frac = self._tune0
        self._tune_slope = None
        self.control = WeakSignalControl(geo, params, self.device)
        self.graphed = want
        if want:
            steps = {}
            for name, shapes in tuning_structures(params, geo).items():
                args = _tuning_args(shapes, self.device)
                if name == "bin":
                    args = self._tune0 + (None,)
                steps[name] = (self._steps[name], args)
            self._capture_graphs(steps, self._tables, self._state,
                                 self._shard_shapes(), _block_dtype(geo),
                                 recorded)
            self._state = None

    def tune(self, freq_hz: float) -> None:
        """Tune to the nearest fftx bin (the sharded steps take no
        fractional-bin ramp until the coherent AFC supplies one)."""
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune0[0].fill_(int(round(freq_hz / fs * n)) % n)
        self._tune0[1].zero_()
        self._tune_bin, self._tune_frac = self._tune0
        self._tune_slope = None
        self.control.on_tune(freq_hz)

    def process_block(self, block) -> RxOutputs:
        """One step: a whole (samples_per_step, C) block, or this
        process's shards' rows as ``scatter_step_block`` gives them."""
        blocks = self._shard_rows(block)
        tune = (self._tune_bin, self._tune_frac, self._tune_slope)
        if self.graphs:
            out = _owned(self._graph_for(tune)(blocks))
        else:
            if self._tune_slope is not None:   # coherent drift tracking
                step = self._steps["coherent"]
            elif self._tune_bin.dim():          # per-frame AFC tuning
                step = self._steps["frames"]
            else:
                step = self._steps["bin"]
            self.state, out = step(self.tables, self.state, blocks, *tune)
        (self._tune_bin, self._tune_frac, self._tune_slope,
         self.state) = self.control.update(
            out, self._tune_bin, self.state, tune_frac=self._tune_frac,
            tune_slope=self._tune_slope)
        return out


class ShardedMultiReceiver(PairedState, _ShardedBase, GraphedReceiver):
    """K independently tuned sub-receivers over one sharded wideband front
    end: the shard-group twin of pipeline.receiver.MultiReceiver.  With
    every shard on one CUDA device the step replays from one CUDA graph,
    as ShardedReceiver's does."""

    def __init__(self, params: RxParams, n_subch: int, devices=None,
                 calibration: dict | None = None, *,
                 graphed: bool | None = None, recorded=None):
        self.graphs = {}
        want = self._setup(params, devices, calibration, graphed)
        self.n_subch = n_subch
        fir_len = _fir_len(self.tables)
        self._state = MultiState(
            rx=RxState.create(self.geo, self.device,
                              spur=self.params.spur_enable, fir_len=fir_len),
            nbs=NBState.create_stacked(
                self.geo, n_subch, self.device,
                pol=self.params.pol_adapt_enable, fir_len=fir_len))
        self._step = pair_step(make_sharded_multi_rx_step(
            self.geo, self.params, self.group, n_subch,
            self.blanker_pulsewidth, tables=self.tables))
        self._tune_bins = torch.zeros(n_subch, dtype=torch.int64,
                                      device=self.device)
        self.graphed = want
        if want:
            self._capture_graphs({"bins": (self._step, (self._tune_bins,))},
                                 self._tables, self._state,
                                 self._shard_shapes(), _block_dtype(self.geo),
                                 recorded)
            self._state = None

    def tune_subch(self, k: int, freq_hz: float) -> None:
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self._tune_bins[k] = int(round(freq_hz / fs * n)) % n

    def process_block(self, block) -> RxOutputs:
        """One step; outputs.audio/baseb/agc_gain have shape (K, S, C)."""
        blocks = self._shard_rows(block)
        if not self.graphs:
            self._state, out = self._step(self.tables, self._state, blocks,
                                          self._tune_bins)
            return out
        return _owned(self._graph_for((self._tune_bins,))(blocks))


class ShardedBatchRunner(_ShardedBase, BatchRunner):
    """Throughput mode over a shard group: K sharded steps per call.

    With every shard on one CUDA device this is a BatchRunner of the
    sharded step: the step (the split of each block among the shards
    included) captured into a CUDA graph, K replays per call, the blocks
    and the collected fields staged through page-locked host memory;
    ``graphed`` is the captured step, as BatchRunner's.  Over several
    devices or a DistGroup (``graphed`` None; ``graphed=True`` raises
    NotImplementedError) a call copies its K blocks to the home device
    once, runs the K sharded steps eagerly one after another and copies
    the collected fields back once: the same function as the JAX runner's
    ``lax.scan`` around the sharded step.  State chains through the steps
    exactly as across streamed ShardedReceiver steps."""

    def __init__(self, params: RxParams, k_steps: int = 16,
                 outputs: tuple = ("audio", "baseb"), devices=None,
                 calibration: dict | None = None, *,
                 graphed: bool | None = None, recorded=None):
        want = self._setup(params, devices, calibration, graphed)
        self.k = int(k_steps)
        self.outputs = tuple(outputs)
        self._recorded = recorded or (lambda: 0)
        state = RxState.create(self.geo, self.device,
                               spur=self.params.spur_enable,
                               pol=self.params.pol_adapt_enable,
                               fir_len=_fir_len(self.tables))
        self._step = make_sharded_rx_step(self.geo, self.params, self.group,
                                          self.blanker_pulsewidth,
                                          tables=self.tables)
        self._tune_bin = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self._rows = _block_rows(self.geo)
        self.graphed = None
        self.kernels_per_replay = 0
        self._state = state
        if want:
            group, step = self.group, self._step

            def whole(tables, state, block, tune_bin):
                return step(tables, state, group.scatter(block, 0), tune_bin)

            self._capture(whole, state, (self._rows, self.geo.channels),
                          _block_dtype(self.geo), (self._tune_bin,))
            self._state = None

    @property
    def state(self) -> RxState:
        return self._state if self.graphed is None else self.graphed.state

    @state.setter
    def state(self, value: RxState) -> None:
        if self.graphed is None:
            self._state = value
        else:
            self.graphed.state = value

    @property
    def kernel_launches(self) -> int:
        return 0 if self.graphed is None else super().kernel_launches

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """Process a recording; returns the concatenated output streams.
        Trailing samples short of a whole K-step call are dropped."""
        if self.graphed is not None:
            return super().process(iq)
        if iq.ndim == 1:
            iq = iq[:, None]
        per = self.k * self._rows
        dtype = _block_dtype(self.geo)
        collected: dict[str, list] = {f: [] for f in self.outputs}
        for i in range(iq.shape[0] // per):
            seg = torch.as_tensor(iq[i * per:(i + 1) * per]).to(
                device=self.device, dtype=dtype)
            seg = seg.reshape(self.k, self._rows, -1)
            stacks: dict[str, list] = {f: [] for f in self.outputs}
            for k in range(self.k):
                self.state, out = self._step(
                    self.tables, self.state, self.group.scatter(seg[k], 0),
                    self._tune_bin)
                for f in self.outputs:
                    stacks[f].append(getattr(out, f))
            for f, v in stacks.items():
                a = torch.stack(v).cpu().numpy()        # (K, S_f, C)
                collected[f].append(a.reshape(-1, a.shape[-1]))
        return {f: (np.concatenate(v) if v else np.zeros((0, 1)))
                for f, v in collected.items()}
