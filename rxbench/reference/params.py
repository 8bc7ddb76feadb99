"""User-facing receiver parameters (the port's own copy of
linrad_tpu/params.py; tests/test_torch_config.py holds the two equal).

TPU-native analog of Linrad's two parameter tiers: the global ``ui``
struct (USERINT_PARM, reference globdef.h:459-516) and the per-mode
``genparm`` DSP parameters (reference globdef.h:288-326, uivar.c:393-427).
Only the parameters that affect DSP semantics survive here; screen/device
fields are replaced by the file/synthetic ingest harness.

Values are plain Python (static at trace time) — the whole pipeline
geometry derives from them once per configuration, exactly like
``get_wideband_sizes`` (reference buf.c:139) runs once per mode start.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass


class InputMode(enum.IntEnum):
    """Input format flags (reference globdef.h IQ_DATA/TWO_CHANNELS bits)."""

    REAL = 0
    IQ = 1


class RxMode(enum.IntEnum):
    """Processing modes (reference globdef.h:125-143 MODE_*)."""

    WCW = 0      # weak-signal CW (full chain: second FFT, blanker, AFC)
    NCW = 1      # normal CW
    HSMS = 2     # high-speed meteor scatter
    SSB = 3
    FM = 4
    AM = 5
    QRSS = 6     # very slow CW
    TXTEST = 7
    RADAR = 8


class Demod(enum.IntEnum):
    """Baseband detector selection (reference mix2.c:1774-1900, fm.c:93)."""

    NONE = 0       # raw complex baseband out
    SSB = 1        # plain BFO product detector (coherent mode 0)
    COHERENT = 2   # carrier-locked I/Q demod (coherent mode 2)
    AM = 3         # envelope detector (mix2.c:1804-1834)
    FM = 4         # angle-difference discriminator (fm.c:93)


@dataclass(frozen=True)
class RxParams:
    """All knobs needed to derive the pipeline geometry.

    Defaults reproduce a typical Linrad SSB setup on a 96 kHz IQ stream.
    """

    # --- input format (ui.rx_* analogs) ---
    rx_ad_speed: int = 96_000          # A/D sample rate in Hz
    input_mode: InputMode = InputMode.IQ
    rx_rf_channels: int = 1            # 1 or 2 (dual polarization)

    # --- frequency control (freq_control.c / ui.converter_mode) ---
    converter_offset_hz: float = 0.0   # LO of an external up/down
                                       # converter ahead of the SDR
    passband_direction: int = 1        # -1 when the converter inverts
                                       # the spectrum (fg.passband_direction)

    # --- first FFT (genparm FIRST_FFT_*) ---
    first_fft_sinpow: int = 2          # window sin^N; 0=none, 1..4, 8=gauss, 9=erfc
    first_fft_bandwidth: float = 100.0  # desired fft1 bin bandwidth in Hz (0 => max size)
    fft1_n_override: int = 0           # force fft1_n (log2 size) when nonzero

    # --- second FFT (genparm SECOND_FFT_*) ---
    second_fft_enable: bool = False
    second_fft_sinpow: int = 2
    second_fft_ninc: int = 1           # resolution increase exponent (buf.c:355-371)

    # --- first mixer (genparm MIX1_*) ---
    mix1_bandwidth_reduction_n: int = 5  # mix1.n = fftx_n - this (buf.c:309-316)

    # --- baseband (subset of Linrad BG_* baseband graph params) ---
    fft3_n: int = 9                    # baseband FFT log2 size (init_baseband_sizes analog)
    fft3_sinpow: int = 2
    mix2_reduction_n: int = 0          # output decimation: mix2.size = fft3_size >> this
    demod: Demod = Demod.SSB
    bfo_hz: float = 800.0              # BFO offset for SSB/CW product detection
    coherent_mode: int = 2             # bg_coherent (mix2.c:1774-1900):
                                       # 1 = signal one ear / carrier
                                       # other ear, 2 = carrier-phase
                                       # I/Q demod (Demod.COHERENT only)
    agc_attack_ms: float = 2.0         # AGC attack time constant (baseb_graph.c:435-437)
    agc_release_ms: float = 250.0
    agc_hang_ms: float = 0.0
    agc_enable: bool = True
    mixer_mode: int = 1                # bg.mixer_mode: 1 = frequency-domain
                                       # filter (mix2.c:146), 2 = time-domain
                                       # FIR decimator on timf3 (mix2.c:217)
    filter_low_hz: float = -1500.0     # baseband passband (user-drawn filter analog)
    filter_high_hz: float = 1500.0
    notches: tuple = ()                # ((freq_hz, width_hz), ...) baseband notches
    filter_shape: tuple = ()           # user-drawn filter curve: ((freq_hz,
                                       # gain_db), ...) dB breakpoints
                                       # (bg_filterfunc analog)
    pol_adapt_enable: bool = False     # 2-channel adaptive polarization
                                       # combination before demod
                                       # (pol_graph.c, applied mix2-side)

    # --- squelch (update_squelch fft3.c:87; gate applied in rxout) ---
    squelch_enable: bool = False
    squelch_ratio: float = 4.0         # open when inband S/N exceeds this
    squelch_tc_ms: float = 50.0        # gate smoothing time constant

    # --- FM extras (fm.c de-emphasis / pilot path) ---
    fm_deemphasis_us: float = 0.0      # 0 = off; 50 (EU) / 75 (US)

    # --- audio expander (the mix2 expander; downward expansion) ---
    expander_exponent: float = 1.0     # 1 = off; >1 expands below ref level

    # --- noise blanker (hg.* hires-graph params, blank1.c) ---
    blanker_enable: bool = False
    clever_bln_limit: float = 12.0     # amplitude threshold over noise (hg.clever_bln_limit)
    stupid_bln_limit: float = 8.0
    max_pulses_per_block: int = 16     # bounded fit-subtract iterations per step
    blanker_block_size: int = 256      # hierarchical candidate-search block
                                       # (0 = flat global argmax per pulse)
    blanker_rounds: int = 0            # >0: parallel variant — fit one pulse
                                       # per alternating block per round,
                                       # sequential depth = rounds

    # --- selective limiter (HG_SELLIM_PAR*, globdef.h:618-626) ---
    sellim_maxlevel: float = 8.0       # strong-signal threshold factor (sellim.c:783-786)
    sellim_smooth: float = 0.2         # new-gain smoothing weight (sellim.c:810-814)
    sellim_ston: float = 30.0          # carrier-vs-floor ratio (hg.blanker_ston_fft1)

    # --- spectrum averaging ---
    fft_avg1num: int = 8               # fft1 power spectrum averaging count

    # --- batching (TPU-specific: frames jitted per pipeline step) ---
    target_fft1_frames_per_step: int = 64
    # fft1 kernel variant (the fft1_version[] analog, fft1var.c:74-79):
    # None = auto (mxu/xla by size), "xla", "mxu", or "pallas" (fused
    # window+DFT+calibration+power kernel, ops/pallas_fft.py)
    fft1_variant: str | None = None
    shards: int = 1   # time-shards (mesh size); every stage's per-shard
                      # chunk must hold an integer number of frames

    # --- AFC (AG_PARMS analogs, globdef.h:884-899) ---
    afc_enable: bool = False
    afc_avgnum: int = 4
    afc_fit_points: int = 10
    afc_max_drift_hz: float = 50.0
    # coherent drift tracking while locked: feed mix1 a constant base
    # bin plus per-frame (frac, slope) ramps (AFCTracker.frame_tuning —
    # the do_mix1_afc intra-transform chirp, mix1.c:648/103-106) instead
    # of stepped integer bins.  Phase-continuous across frames.
    afc_coherent: bool = True

    # --- spur cancellation (spur.c / spursub.c) ---
    spur_enable: bool = False

    def __post_init__(self):
        if self.rx_rf_channels not in (1, 2):
            raise ValueError("rx_rf_channels must be 1 or 2")
        if self.first_fft_sinpow not in (0, 1, 2, 3, 4, 8, 9):
            raise ValueError("first_fft_sinpow must be 0-4, 8 or 9")
        if self.second_fft_sinpow not in (1, 2, 3, 4, 8, 9):
            raise ValueError("second_fft_sinpow must be 1-4, 8 or 9")
        if self.fft3_sinpow not in (1, 2):
            raise ValueError("fft3_sinpow must be 1 or 2 (50%-overlap baseband)")

    # --- persistence: the par_userint / par_<mode> analog -----------------
    # Version code semantics follow vernr.h: every saved file carries
    # `check`; a major mismatch forces re-setup (the reference discards
    # the file and re-runs parameter entry, xmain.c:1605-1632).
    PAR_VERNR = 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["input_mode"] = int(self.input_mode)
        d["demod"] = int(self.demod)
        d["check"] = self.PAR_VERNR
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str, strict: bool = False) -> "RxParams":
        d = json.loads(text)
        check = d.pop("check", cls.PAR_VERNR)
        if check != cls.PAR_VERNR:
            raise ValueError(
                f"parameter file version {check} != {cls.PAR_VERNR}: "
                "re-setup required (vernr.h semantics)")
        if not strict:
            # files written by older builds may lack new fields (their
            # defaults apply) and newer builds may have extra ones
            names = {f.name for f in dataclasses.fields(cls)}
            d = {k: v for k, v in d.items() if k in names}
        d["input_mode"] = InputMode(d["input_mode"])
        d["demod"] = Demod(d["demod"])
        d["notches"] = tuple(tuple(n) for n in d.get("notches", ()))
        d["filter_shape"] = tuple(tuple(n)
                                  for n in d.get("filter_shape", ()))
        return cls(**d)


def preset(mode: RxMode, **overrides) -> RxParams:
    """Per-mode defaults, the analog of Linrad's per-mode genparm files
    (par_wcw_*, reference uivar.c:393-427)."""
    base = dict()
    if mode == RxMode.WCW:
        base.update(
            second_fft_enable=True,
            blanker_enable=True,
            afc_enable=True,
            first_fft_bandwidth=30.0,
            demod=Demod.COHERENT,
            bfo_hz=600.0,
            filter_low_hz=-150.0,
            filter_high_hz=150.0,
        )
    elif mode == RxMode.NCW:
        base.update(
            second_fft_enable=True,
            blanker_enable=True,
            first_fft_bandwidth=60.0,
            demod=Demod.SSB,
            bfo_hz=600.0,
            filter_low_hz=-250.0,
            filter_high_hz=250.0,
        )
    elif mode == RxMode.QRSS:
        base.update(
            second_fft_enable=True,
            second_fft_ninc=3,
            afc_enable=True,
            first_fft_bandwidth=10.0,
            demod=Demod.SSB,
        )
    elif mode == RxMode.SSB:
        base.update(demod=Demod.SSB, first_fft_bandwidth=100.0)
    elif mode == RxMode.FM:
        base.update(demod=Demod.FM, filter_low_hz=-8000.0, filter_high_hz=8000.0,
                    mix1_bandwidth_reduction_n=2)
    elif mode == RxMode.AM:
        base.update(demod=Demod.AM, filter_low_hz=-4000.0, filter_high_hz=4000.0)
    elif mode == RxMode.HSMS:
        base.update(demod=Demod.SSB, first_fft_bandwidth=300.0)
    base.update(overrides)
    return RxParams(**base)
