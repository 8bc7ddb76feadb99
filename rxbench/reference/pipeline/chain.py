"""The signal chain: one pipeline step (port of
linrad_tpu/pipeline/chain.py).

    state, outputs = step(tables, state, block, tune_bin, tune_frac,
                          tune_slope)

fft1 -> sellim -> weak/strong back transform -> noise floor, clever and
stupid blankers -> fft2 -> spur subtraction -> mix1 -> fft3 -> mix2 (the
frequency-domain filter or the mixer-mode-2 FIR, and the carrier branch)
-> adaptive polarization -> detector (SSB, AM, FM, coherent, none) -> AGC
-> expander -> squelch, on tensors that stay on one device.  PyTorch runs
it eagerly; nothing in the step waits for the host.

The narrowband tail (mix1 onwards) is written against trailing
dimensions: streams are (..., S, C) and every state tensor of an
:class:`NBState` may carry the same leading axes.  The single receiver
runs it with no leading axis; :func:`make_multi_rx_step` runs the same
code once on an ``NBState`` stacked over K sub-receivers, so K
sub-receivers cost one set of device operations, not K.

A ``shards=d`` configuration only changes the geometry (every stage's
frames divide by d): this step runs it on one device, and
:mod:`..parallel.sharded` runs the same stages split over d shards.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..geometry import Geometry
from ..ops import agc as agc_ops
from ..ops import blanker as blanker_ops
from ..ops import demod as demod_ops
from ..ops import sellim as sellim_ops
from ..ops.blanker import BlankerState, BlankerTables
from ..ops.fft1 import FFT1State, FFT1Tables, fft1_step
from ..ops.fft2 import (FFT2State, FFT2Tables, fft2_power_update,
                        fft2_transform)
from ..ops.fft3 import FFT3State, FFT3Tables, fft3_step
from ..ops.mix1 import Mix1State, Mix1Tables, mix1_step
from ..ops.mix2 import (Mix2FirState, Mix2State, Mix2Tables,
                        mix2_carrier_step, mix2_fir_step, mix2_step)
from ..ops.sellim import SellimState
from ..ops.squelch import SquelchState, expander, squelch_step
from ..ops.timf2 import Timf2State, make_timf2_syn, timf2_step
from ..params import Demod, RxParams
from ..weak.pol import PolState, project, update_polarization
from ..weak.spur import (SpurState, spur_subtract_step,
                         window_template_table)


@dataclass(frozen=True)
class RxTables:
    fft1: FFT1Tables
    mix1: Mix1Tables
    fft3: FFT3Tables
    mix2: Mix2Tables
    fft2: FFT2Tables | None
    timf2_syn: torch.Tensor | None
    blanker: BlankerTables | None
    spur_template: torch.Tensor | None = None

    @classmethod
    def create(cls, geo: Geometry, p: RxParams, device,
               calibration: dict | None = None) -> "RxTables":
        calibration = calibration or {}
        fft2 = timf2_syn = blanker = spur_tpl = None
        if geo.second_fft_enable:
            fft2 = FFT2Tables.create(geo, device)
            timf2_syn = make_timf2_syn(geo, device)
            blanker, _pw = BlankerTables.create(geo, device)
        if p.spur_enable:
            sinpow = (geo.fft2_sinpow if geo.second_fft_enable
                      else geo.fft1_sinpow)
            spur_tpl = torch.from_numpy(
                window_template_table(geo.fftx_size, sinpow)).to(device)
        return cls(fft1=FFT1Tables.create(
                       geo, device, filtercorr=calibration.get("filtercorr"),
                       iq_corr=calibration.get("iq_corr")),
                   mix1=Mix1Tables.create(geo, device),
                   fft3=FFT3Tables.create(geo, device),
                   mix2=Mix2Tables.create(geo, p, device),
                   fft2=fft2, timf2_syn=timf2_syn, blanker=blanker,
                   spur_template=spur_tpl)


@dataclass
class RxState:
    fft1: FFT1State
    mix1: Mix1State
    fft3: FFT3State
    mix2: Mix2State
    bfo: demod_ops.BFOState
    am: demod_ops.AMState
    fm: demod_ops.FMState
    coh: demod_ops.CoherentState
    agc: agc_ops.AGCState
    sellim: SellimState | None
    timf2: Timf2State | None
    fft2: FFT2State | None
    blanker: BlankerState | None
    spur: SpurState | None = None
    squelch: SquelchState | None = None
    pol: PolState | None = None
    mix2_fir: Mix2FirState | None = None  # mixer_mode-2 timf3 history

    @classmethod
    def create(cls, geo: Geometry, device, spur: bool = False,
               pol: bool = False, fir_len: int = 0,
               audio_channels: int | None = None) -> "RxState":
        wide = geo.second_fft_enable
        nb = NBState.create(geo, device, pol=pol, fir_len=fir_len,
                            audio_channels=audio_channels)
        return cls(
            fft1=FFT1State.create(geo, device),
            sellim=SellimState.create(geo, device) if wide else None,
            timf2=Timf2State.create(geo, device) if wide else None,
            fft2=FFT2State.create(geo, device) if wide else None,
            blanker=BlankerState.create(geo, device) if wide else None,
            spur=SpurState.create(geo, device) if spur else None,
            **nb.fields())


@dataclass
class RxOutputs:
    """Per-step observable outputs (the stage taps of globdef.h:237-253)."""

    audio: torch.Tensor           # (S_audio, C) float32 demodulated audio
    baseb: torch.Tensor           # (S_bb, C) complex64 filtered baseband
    fft1_power: torch.Tensor      # (fft1_size, C) float32 step power
    fft1_avg_power: torch.Tensor  # slow average (fft1_sumsq analog)
    agc_gain: torch.Tensor        # (S_bb, C) float32
    fft2_power: torch.Tensor | None       # (fft2_size, C) float32
    liminfo: torch.Tensor | None          # (fft1_size,) float32
    blanker_fitted: torch.Tensor | None   # () int32 pulses subtracted
    blanker_cleared: torch.Tensor | None  # () int32 points hard-cleared
    noise_floor: torch.Tensor | None      # () float32


@dataclass
class NBState:
    """Narrowband state of one sub-receiver (one mix1 channel of the
    reference's MIX1_NO_OF_CHANNELS=24 slots, globdef.h:315), or of K of
    them stacked on a leading axis (:meth:`create_stacked`)."""

    mix1: Mix1State
    fft3: FFT3State
    mix2: Mix2State
    bfo: demod_ops.BFOState
    am: demod_ops.AMState
    fm: demod_ops.FMState
    coh: demod_ops.CoherentState
    agc: agc_ops.AGCState
    squelch: SquelchState | None = None
    pol: PolState | None = None
    mix2_fir: Mix2FirState | None = None

    @classmethod
    def create(cls, geo: Geometry, device, pol: bool = False,
               fir_len: int = 0,
               audio_channels: int | None = None) -> "NBState":
        # adaptive polarization combines the 2 channels into 1 before the
        # detectors, so the detector/AGC state is single-channel then;
        # coherent mode 1 doubles it (signal ear + carrier ear)
        c = audio_channels or (1 if pol else geo.channels)
        return cls(
            mix1=Mix1State.create(geo, device),
            fft3=FFT3State.create(geo, device),
            mix2=Mix2State.create(geo, device),
            bfo=demod_ops.BFOState.create(device),
            am=demod_ops.AMState.create(c, device),
            fm=demod_ops.FMState.create(c, device),
            coh=demod_ops.CoherentState.create(c, device),
            agc=agc_ops.AGCState.create(c, device),
            squelch=SquelchState.create(device),
            pol=PolState.create(device) if pol else None,
            mix2_fir=(Mix2FirState.create(geo, fir_len, device) if fir_len
                      else None))

    @classmethod
    def create_stacked(cls, geo: Geometry, n_subch: int, device,
                       pol: bool = False, fir_len: int = 0) -> "NBState":
        """K independent sub-receiver states stacked on a leading axis
        (the batch axis of the multi-receiver step)."""
        one = cls.create(geo, device, pol=pol, fir_len=fir_len)
        return _map_tensors(
            lambda x: x[None].repeat((n_subch,) + (1,) * x.dim()), one)

    @classmethod
    def from_rx(cls, s: RxState) -> "NBState":
        return cls(**{f.name: getattr(s, f.name)
                      for f in dataclasses.fields(cls)})

    def fields(self) -> dict:
        """The sub-states by field name (the keyword arguments that put
        them back into an :class:`RxState`)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def _map_tensors(fn, tree):
    """Apply fn to every tensor of a tree of dataclasses (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(**{f.name: _map_tensors(fn, getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def _wideband_front(geo: Geometry, p: RxParams, blanker_pulsewidth: int,
                    tables: RxTables, state: RxState, block: torch.Tensor,
                    tune0: torch.Tensor):
    """fft1 -> sellim -> back-FFT -> blankers -> fft2 -> spur subtraction
    (the wideband chain that feeds every sub-receiver).  Returns (wide
    states, fftx_spec, aux)."""
    s_fft1, fft1_spec, step_power = fft1_step(
        geo, tables.fft1, state.fft1, block, p.fft_avg1num,
        variant=p.fft1_variant)
    wide = dict(fft1=s_fft1, sellim=state.sellim, timf2=state.timf2,
                fft2=state.fft2, blanker=state.blanker, spur=state.spur)
    aux = dict(step_power=step_power, fft2_power=None, liminfo=None,
               blanker_fitted=None, blanker_cleared=None, noise_floor=None)
    if not geo.second_fft_enable:
        fftx_spec = fft1_spec
        if p.spur_enable:
            wide["spur"], fftx_spec = spur_subtract_step(
                geo, tables.spur_template, state.spur, fftx_spec)
        return wide, fftx_spec, aux
    # protected passband in fft1-bin coordinates (selfreq_liminfo,
    # sellim.c:38-116)
    sel_c = torch.div(tune0, geo.fft2_size // geo.fft1_size,
                      rounding_mode="floor")
    bw_bins = max(1, int(0.7 * (p.filter_high_hz - p.filter_low_hz)
                         / geo.fft1_bandwidth)) + 3
    s_sellim = sellim_ops.update_liminfo(
        geo, state.sellim, s_fft1.sumsq_avg.sum(-1), p.sellim_maxlevel,
        ston=p.sellim_ston, sel_lo=sel_c - bw_bins, sel_hi=sel_c + bw_bins)
    wgain, sgain = sellim_ops.liminfo_gains(s_sellim.liminfo)
    s_timf2, weak, strong, wpwr = timf2_step(
        geo, tables.timf2_syn, state.timf2, fft1_spec, wgain, sgain)
    nf = state.blanker.noise_floor
    zero = torch.zeros((), dtype=torch.int32, device=block.device)
    n_fit = n_clear = zero
    # track the floor from the PRE-blank power (see the JAX version)
    s_blank = blanker_ops.update_noise_floor(
        state.blanker, wpwr, geo.samples_per_step / geo.timf1_sampling_speed)
    if p.blanker_enable:
        weak, wpwr, n_fit = blanker_ops.clever_blanker(
            weak, wpwr, tables.blanker, nf, p.clever_bln_limit,
            blanker_pulsewidth, p.max_pulses_per_block,
            block_size=p.blanker_block_size, rounds=p.blanker_rounds)
        weak, wpwr, n_clear = blanker_ops.stupid_blanker(
            weak, wpwr, nf, p.stupid_bln_limit, blanker_pulsewidth)
    t2_tail, fftx_spec = fft2_transform(geo, tables.fft2, state.fft2.tail,
                                        weak, strong)
    if p.spur_enable:
        # subtract BEFORE the power spectrum, as the reference runs
        # eliminate_spurs ahead of its power block (fft2.c:648-670):
        # cancelled spurs vanish from the waterfall and the auto-search
        # never adds them again
        wide["spur"], fftx_spec = spur_subtract_step(
            geo, tables.spur_template, state.spur, fftx_spec)
    s_fft2, fft2_power = fft2_power_update(geo, state.fft2, t2_tail,
                                           fftx_spec, p.fft_avg1num)
    wide.update(sellim=s_sellim, timf2=s_timf2, fft2=s_fft2,
                blanker=s_blank)
    aux.update(fft2_power=fft2_power, liminfo=s_sellim.liminfo,
               blanker_fitted=n_fit, blanker_cleared=n_clear,
               noise_floor=s_blank.noise_floor)
    return wide, fftx_spec, aux


def narrowband_post_mix1(geo: Geometry, p: RxParams, tables: RxTables,
                         nb: NBState, s_mix1: Mix1State,
                         timf3: torch.Tensor):
    """fft3 -> mix2 -> polarization -> detector -> AGC, expander, squelch
    on a timf3 stream (..., S3, C) that is already downconverted.

    Returns (nb', audio, baseb, agc_gain)."""
    fs_bb = geo.baseband_sampling_speed
    with_carrier = p.demod == Demod.COHERENT
    s_fft3, fft3_spec = fft3_step(geo, tables.fft3, nb.fft3, timf3)
    s_fir = nb.mix2_fir
    if p.mixer_mode == 2:
        # time-domain FIR decimator (mix2.c:217-245); the carrier branch
        # still comes from fft3 (mix2.c:246 runs either way)
        s_fir, baseb = mix2_fir_step(geo, tables.mix2.fir, nb.mix2_fir,
                                     timf3)
        s_mix2, carrier = nb.mix2, None
        if with_carrier:
            s_mix2, carrier = mix2_carrier_step(geo, tables.mix2, nb.mix2,
                                                fft3_spec)
    else:
        s_mix2, baseb, carrier = mix2_step(geo, tables.mix2, nb.mix2,
                                           fft3_spec,
                                           with_carrier=with_carrier)
    s_pol = nb.pol
    if p.pol_adapt_enable and geo.channels == 2:
        # project the 2-channel baseband onto the dominant coherency
        # eigenvector (pol_graph.c channel combination)
        s_pol, combined, w = update_polarization(nb.pol, baseb)
        baseb = combined[..., None]
        if carrier is not None:
            carrier = project(carrier, w)[..., None]
    s_bfo, s_am, s_fm, s_coh = nb.bfo, nb.am, nb.fm, nb.coh
    if p.demod == Demod.SSB:
        s_bfo, audio = demod_ops.bfo_ssb(nb.bfo, baseb, p.bfo_hz, fs_bb)
    elif p.demod == Demod.AM:
        s_am, audio = demod_ops.am_detect(nb.am, baseb, fs_bb)
    elif p.demod == Demod.FM:
        s_fm, audio = demod_ops.fm_detect(nb.fm, baseb, fs_bb)
        if p.fm_deemphasis_us > 0:
            audio, de_last = demod_ops.fm_deemphasis(
                audio, fs_bb, p.fm_deemphasis_us, s_fm.deemph)
            s_fm = demod_ops.FMState(last=s_fm.last, deemph=de_last)
    elif p.demod == Demod.COHERENT:
        if p.coherent_mode == 1:
            # signal to one ear, the narrow carrier branch to the other
            # (bg_coherent 1, mix2.c:1843-1876); both get the BFO product
            s_bfo, audio = demod_ops.bfo_ssb(
                nb.bfo, torch.cat([baseb, carrier], dim=-1), p.bfo_hz,
                fs_bb)
        else:
            s_coh, audio_i, _audio_q = demod_ops.coherent_detect(
                nb.coh, baseb, carrier, fs_bb)
            s_bfo, audio = demod_ops.bfo_ssb(
                nb.bfo, audio_i.to(torch.complex64), p.bfo_hz, fs_bb)
    else:  # Demod.NONE: the baseband's real part as audio
        audio = baseb.real
    if p.agc_enable:
        s_agc, audio, gain = agc_ops.agc(nb.agc, audio, fs_bb,
                                         p.agc_attack_ms, p.agc_release_ms,
                                         p.agc_hang_ms)
    else:
        s_agc, gain = nb.agc, torch.ones_like(audio)
    if p.expander_exponent > 1.0:
        audio = expander(audio, p.expander_exponent)
    s_squelch = nb.squelch
    if p.squelch_enable:
        s_squelch, audio, _open = squelch_step(
            geo, nb.squelch, fft3_spec, tables.mix2.filt, p.squelch_ratio,
            p.squelch_tc_ms, audio)
    nb_out = NBState(mix1=s_mix1, fft3=s_fft3, mix2=s_mix2, bfo=s_bfo,
                     am=s_am, fm=s_fm, coh=s_coh, agc=s_agc,
                     squelch=s_squelch, pol=s_pol, mix2_fir=s_fir)
    return nb_out, audio, baseb, gain


def narrowband_tail(geo: Geometry, p: RxParams, tables: RxTables,
                    nb: NBState, fftx_spec: torch.Tensor,
                    tune_bin: torch.Tensor,
                    tune_frac: torch.Tensor | None = None,
                    tune_slope: torch.Tensor | None = None):
    """mix1 -> fft3 -> mix2 -> detector -> AGC, expander, squelch for one
    tuned sub-receiver, or for K of them at once when ``nb`` is stacked
    (tune_bin then (K, 1) or (K, n): see :func:`..ops.mix1.mix1_step`).
    With per-frame tune_frac and tune_slope (AFCTracker.frame_tuning) mix1
    follows a drifting signal coherently.

    Returns (nb', audio, baseb, agc_gain)."""
    s_mix1, timf3 = mix1_step(geo, tables.mix1, nb.mix1, fftx_spec,
                              tune_bin, tune_frac=tune_frac,
                              tune_slope=tune_slope)
    return narrowband_post_mix1(geo, p, tables, nb, s_mix1, timf3)


def _outputs(wide: dict, aux: dict, audio, baseb, gain) -> RxOutputs:
    return RxOutputs(audio=audio, baseb=baseb,
                     fft1_power=aux["step_power"],
                     fft1_avg_power=wide["fft1"].sumsq_avg,
                     agc_gain=gain, fft2_power=aux["fft2_power"],
                     liminfo=aux["liminfo"],
                     blanker_fitted=aux["blanker_fitted"],
                     blanker_cleared=aux["blanker_cleared"],
                     noise_floor=aux["noise_floor"])


def make_rx_step(geo: Geometry, p: RxParams, blanker_pulsewidth: int = 2,
                 fractional_tune: bool = False):
    """Build the step function for this configuration.

    Returns ``step(tables, state, block, tune_bin, tune_frac=None,
    tune_slope=None) -> (state, outputs)`` with block (samples_per_step, C)
    complex64 (real input: (2*samples_per_step, C) float32) and tune_bin an
    integer fftx bin tensor, () or per frame (n_fftx,) on the AFC path
    (retuning changes no shape).  With ``fractional_tune`` the step also
    applies ``tune_frac``, the float32 bin fraction of set_mix1_phases
    (mix1.c:781), so any dial frequency lands exactly at DC, and
    ``tune_slope``, the per-frame drift in bins per hop that the AFC
    supplies while it tracks."""

    def step(tables: RxTables, state: RxState, block: torch.Tensor,
             tune_bin: torch.Tensor, tune_frac: torch.Tensor | None = None,
             tune_slope: torch.Tensor | None = None
             ) -> tuple[RxState, RxOutputs]:
        if not fractional_tune:
            tune_frac = tune_slope = None
        tune0 = tune_bin.reshape(-1)[0]
        wide, fftx_spec, aux = _wideband_front(geo, p, blanker_pulsewidth,
                                               tables, state, block, tune0)
        nb, audio, baseb, gain = narrowband_tail(
            geo, p, tables, NBState.from_rx(state), fftx_spec, tune_bin,
            tune_frac=tune_frac, tune_slope=tune_slope)
        new_state = RxState(**wide, **nb.fields())
        return new_state, _outputs(wide, aux, audio, baseb, gain)

    return step


def make_multi_rx_step(geo: Geometry, p: RxParams,
                       blanker_pulsewidth: int = 2):
    """Multi-sub-receiver step: ONE wideband front end feeding K
    independently tuned narrowband sub-receivers.

    The reference reserves MIX1_NO_OF_CHANNELS=24 mix1 channel slots
    (globdef.h:315) and fans narrowband "userx" consumers out over the
    network (NET_RX_STRUCT globdef.h:1282-1294).  Here the sub-receivers
    are a leading axis of the narrowband tail's tensors: the tail runs
    once, its small FFTs, filters and scans batched across sub-receivers.

    Returns ``step(tables, state, nbs, block, tune_bins) -> ((state, nbs),
    outputs)`` where nbs is an NBState with leading axis K
    (NBState.create_stacked) and tune_bins is integer (K,), or (K, n) for
    per-frame tuning of each sub-receiver (integer bins only: no
    tune_frac).  outputs.audio/baseb/agc_gain carry the K axis in front;
    the narrowband fields of ``state`` pass through unchanged."""

    def step(tables: RxTables, state: RxState, nbs: NBState,
             block: torch.Tensor, tune_bins: torch.Tensor):
        tune0 = tune_bins.reshape(-1)[0]
        wide, fftx_spec, aux = _wideband_front(geo, p, blanker_pulsewidth,
                                               tables, state, block, tune0)
        k = tune_bins.shape[0]
        nbs_out, audio, baseb, gain = narrowband_tail(
            geo, p, tables, nbs, fftx_spec, tune_bins.reshape(k, -1))
        new_state = dataclasses.replace(state, **wide)
        return (new_state, nbs_out), _outputs(wide, aux, audio, baseb, gain)

    return step
