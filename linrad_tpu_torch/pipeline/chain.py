"""The signal chain: one pipeline step (port of
linrad_tpu/pipeline/chain.py).

    state, outputs = step(tables, state, iq_block, tune_bin, tune_frac)

fft1 -> sellim -> weak/strong back transform -> noise floor, clever and
stupid blankers -> fft2 -> mix1 -> fft3 -> mix2 -> BFO (SSB) -> AGC, on
tensors that stay on one device.  PyTorch runs it eagerly; nothing in the
step waits for the host.

Ported configurations: single-channel IQ input, SSB demodulation, mixer
mode 1, second FFT and blankers on or off, AGC on or off.  Everything
else raises NotImplementedError naming the ROADMAP entry that ports it
(:func:`check_supported`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from linrad_tpu.geometry import Geometry
from linrad_tpu.params import Demod, InputMode, RxParams

from ..ops import agc as agc_ops
from ..ops import blanker as blanker_ops
from ..ops import demod as demod_ops
from ..ops import sellim as sellim_ops
from ..ops.blanker import BlankerState, BlankerTables
from ..ops.fft import UNPORTED_VARIANTS
from ..ops.fft1 import FFT1State, FFT1Tables, fft1_step
from ..ops.fft2 import (FFT2State, FFT2Tables, fft2_power_update,
                        fft2_transform)
from ..ops.fft3 import FFT3State, FFT3Tables, fft3_step
from ..ops.mix1 import Mix1State, Mix1Tables, mix1_step
from ..ops.mix2 import Mix2State, Mix2Tables, mix2_step
from ..ops.sellim import SellimState
from ..ops.timf2 import Timf2State, make_timf2_syn, timf2_step


def check_supported(p: RxParams) -> None:
    """Raise NotImplementedError for a configuration off the ported slice."""
    refused = []
    q13 = "ROADMAP queue 1 item 13"
    if p.input_mode != InputMode.IQ:
        refused.append(f"real input ({q13})")
    if p.rx_rf_channels != 1:
        refused.append(f"2-channel input ({q13})")
    if p.demod != Demod.SSB:
        refused.append(f"demod {p.demod.name} ({q13})")
    if p.mixer_mode != 1:
        refused.append(f"mixer_mode {p.mixer_mode} ({q13})")
    if p.squelch_enable:
        refused.append(f"squelch ({q13})")
    if p.expander_exponent > 1.0:
        refused.append(f"expander ({q13})")
    if p.pol_adapt_enable:
        refused.append(f"adaptive polarization ({q13})")
    if p.spur_enable:
        refused.append(f"spur cancellation ({q13})")
    if p.afc_enable:
        refused.append("AFC (ROADMAP queue 1 item 12)")
    if p.blanker_rounds > 0:
        refused.append("blanker_rounds>0, the TPU-only round-parallel "
                       "blanker (ROADMAP 'Not ported')")
    if p.fft1_variant in UNPORTED_VARIANTS:
        refused.append(f"fft1_variant {p.fft1_variant!r} (ROADMAP queue 2 "
                       f"item 2)")
    if p.shards != 1:
        refused.append("time-sharded steps (ROADMAP queue 1 item 14)")
    if refused:
        raise NotImplementedError("not ported yet: " + "; ".join(refused))


@dataclass(frozen=True)
class RxTables:
    fft1: FFT1Tables
    mix1: Mix1Tables
    fft3: FFT3Tables
    mix2: Mix2Tables
    fft2: FFT2Tables | None
    timf2_syn: torch.Tensor | None
    blanker: BlankerTables | None

    @classmethod
    def create(cls, geo: Geometry, p: RxParams, device,
               calibration: dict | None = None) -> "RxTables":
        calibration = calibration or {}
        if calibration.get("iq_corr") is not None:
            raise NotImplementedError("I/Q image correction (iq_corr) is "
                                      "not ported; see ROADMAP queue 1 "
                                      "item 13")
        fft2 = timf2_syn = blanker = None
        if geo.second_fft_enable:
            fft2 = FFT2Tables.create(geo, device)
            timf2_syn = make_timf2_syn(geo, device)
            blanker, _pw = BlankerTables.create(geo, device)
        return cls(fft1=FFT1Tables.create(
                       geo, device, filtercorr=calibration.get("filtercorr")),
                   mix1=Mix1Tables.create(geo, device),
                   fft3=FFT3Tables.create(geo, device),
                   mix2=Mix2Tables.create(geo, p, device),
                   fft2=fft2, timf2_syn=timf2_syn, blanker=blanker)


@dataclass
class RxState:
    fft1: FFT1State
    mix1: Mix1State
    fft3: FFT3State
    mix2: Mix2State
    bfo: demod_ops.BFOState
    agc: agc_ops.AGCState
    sellim: SellimState | None
    timf2: Timf2State | None
    fft2: FFT2State | None
    blanker: BlankerState | None

    @classmethod
    def create(cls, geo: Geometry, device) -> "RxState":
        wide = geo.second_fft_enable
        return cls(
            fft1=FFT1State.create(geo, device),
            mix1=Mix1State.create(geo, device),
            fft3=FFT3State.create(geo, device),
            mix2=Mix2State.create(geo, device),
            bfo=demod_ops.BFOState.create(device),
            agc=agc_ops.AGCState.create(geo.channels, device),
            sellim=SellimState.create(geo, device) if wide else None,
            timf2=Timf2State.create(geo, device) if wide else None,
            fft2=FFT2State.create(geo, device) if wide else None,
            blanker=BlankerState.create(geo, device) if wide else None)


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


def _wideband_front(geo: Geometry, p: RxParams, blanker_pulsewidth: int,
                    tables: RxTables, state: RxState, block: torch.Tensor,
                    tune0: torch.Tensor):
    """fft1 -> sellim -> back-FFT -> blankers -> fft2 (the wideband chain
    feeding the narrowband tail).  Returns (wide states, fftx_spec, aux)."""
    s_fft1, fft1_spec, step_power = fft1_step(
        geo, tables.fft1, state.fft1, block, p.fft_avg1num,
        variant=p.fft1_variant)
    wide = dict(fft1=s_fft1, sellim=state.sellim, timf2=state.timf2,
                fft2=state.fft2, blanker=state.blanker)
    aux = dict(step_power=step_power, fft2_power=None, liminfo=None,
               blanker_fitted=None, blanker_cleared=None, noise_floor=None)
    if not geo.second_fft_enable:
        return wide, fft1_spec, aux
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
            block_size=p.blanker_block_size)
        weak, wpwr, n_clear = blanker_ops.stupid_blanker(
            weak, wpwr, nf, p.stupid_bln_limit, blanker_pulsewidth)
    t2_tail, fftx_spec = fft2_transform(geo, tables.fft2, state.fft2.tail,
                                        weak, strong)
    s_fft2, fft2_power = fft2_power_update(geo, state.fft2, t2_tail,
                                           fftx_spec, p.fft_avg1num)
    wide.update(sellim=s_sellim, timf2=s_timf2, fft2=s_fft2,
                blanker=s_blank)
    aux.update(fft2_power=fft2_power, liminfo=s_sellim.liminfo,
               blanker_fitted=n_fit, blanker_cleared=n_clear,
               noise_floor=s_blank.noise_floor)
    return wide, fftx_spec, aux


def narrowband_post_mix1(geo: Geometry, p: RxParams, tables: RxTables,
                         state: RxState, timf3: torch.Tensor):
    """fft3 -> mix2 -> BFO (SSB) -> AGC on the timf3 stream.

    Returns (fft3, mix2, bfo, agc states, audio, baseb, agc_gain)."""
    s_fft3, fft3_spec = fft3_step(geo, tables.fft3, state.fft3, timf3)
    s_mix2, baseb = mix2_step(geo, tables.mix2, state.mix2, fft3_spec)
    fs_bb = geo.baseband_sampling_speed
    s_bfo, audio = demod_ops.bfo_ssb(state.bfo, baseb, p.bfo_hz, fs_bb)
    if p.agc_enable:
        s_agc, audio, gain = agc_ops.agc(state.agc, audio, fs_bb,
                                         p.agc_attack_ms, p.agc_release_ms,
                                         p.agc_hang_ms)
    else:
        s_agc, gain = state.agc, torch.ones_like(audio)
    return s_fft3, s_mix2, s_bfo, s_agc, audio, baseb, gain


def narrowband_tail(geo: Geometry, p: RxParams, tables: RxTables,
                    state: RxState, fftx_spec: torch.Tensor,
                    tune_bin: torch.Tensor,
                    tune_frac: torch.Tensor | None = None):
    """mix1 -> fft3 -> mix2 -> BFO -> AGC for the tuned receiver.

    Returns (mix1, fft3, mix2, bfo, agc states, audio, baseb, agc_gain)."""
    s_mix1, timf3 = mix1_step(geo, tables.mix1, state.mix1, fftx_spec,
                              tune_bin, tune_frac=tune_frac)
    return (s_mix1,) + narrowband_post_mix1(geo, p, tables, state, timf3)


def make_rx_step(geo: Geometry, p: RxParams, blanker_pulsewidth: int = 2,
                 fractional_tune: bool = False):
    """Build the step function for this configuration.

    Returns ``step(tables, state, block, tune_bin, tune_frac=None) ->
    (state, outputs)`` with block (samples_per_step, C) complex64 and
    tune_bin an integer fftx bin tensor (retuning changes no shape).  With
    ``fractional_tune`` the step also applies ``tune_frac``, the float32
    bin fraction of set_mix1_phases (mix1.c:781), so any dial frequency
    lands exactly at DC."""
    check_supported(p)

    def step(tables: RxTables, state: RxState, block: torch.Tensor,
             tune_bin: torch.Tensor, tune_frac: torch.Tensor | None = None,
             tune_slope: torch.Tensor | None = None
             ) -> tuple[RxState, RxOutputs]:
        if tune_slope is not None:
            raise NotImplementedError("tune_slope (AFC drift tracking) is "
                                      "not ported; see ROADMAP queue 1 "
                                      "item 12")
        if not fractional_tune:
            tune_frac = None
        tune0 = tune_bin.reshape(-1)[0]
        wide, fftx_spec, aux = _wideband_front(geo, p, blanker_pulsewidth,
                                               tables, state, block, tune0)
        (s_mix1, s_fft3, s_mix2, s_bfo, s_agc, audio, baseb,
         gain) = narrowband_tail(geo, p, tables, state, fftx_spec, tune_bin,
                                 tune_frac=tune_frac)
        new_state = RxState(fft1=wide["fft1"], mix1=s_mix1, fft3=s_fft3,
                            mix2=s_mix2, bfo=s_bfo, agc=s_agc,
                            sellim=wide["sellim"], timf2=wide["timf2"],
                            fft2=wide["fft2"], blanker=wide["blanker"])
        outputs = RxOutputs(audio=audio, baseb=baseb,
                            fft1_power=aux["step_power"],
                            fft1_avg_power=wide["fft1"].sumsq_avg,
                            agc_gain=gain, fft2_power=aux["fft2_power"],
                            liminfo=aux["liminfo"],
                            blanker_fitted=aux["blanker_fitted"],
                            blanker_cleared=aux["blanker_cleared"],
                            noise_floor=aux["noise_floor"])
        return new_state, outputs

    return step
