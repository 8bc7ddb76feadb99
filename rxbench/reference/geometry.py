"""Pipeline geometry derivation (the port's own copy of
linrad_tpu/geometry.py; tests/test_torch_config.py holds the two equal).

TPU-native analog of ``get_wideband_sizes`` / ``fft1_block_timing`` /
``make_interleave_ratio`` (reference buf.c:43-560).  All sizes are static
Python ints computed once per configuration, so every jitted kernel sees
fully static shapes.

The key structural difference from the reference: Linrad sizes circular
buffers and DMA blocks to bound *latency* on a CPU; here everything is
expressed per *pipeline step* — a batch of overlapped FFT frames processed
by one jitted call — so the derivation additionally computes the exact
number of frames each stage produces per step (all integers by
construction, see ``samples_per_step``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .params import InputMode, RxParams


def interleave_ratio(sinpow: int) -> float:
    """Fraction of the transform where the sin^N window is >= 0.5.

    Reference ``make_interleave_ratio`` buf.c:113-137: ratio =
    2*asin(0.5^(1/N))/pi for N=1..7; special windows: 8 (Gaussian) -> 0.8,
    9 (erfc) -> 0.625; N=0 -> no window, no overlap.
    """
    if sinpow == 0:
        return 0.0
    if sinpow == 9:
        return 0.625
    if sinpow == 8:
        return 0.8
    return 2.0 * math.asin(0.5 ** (1.0 / sinpow)) / math.pi


def _lcm(*vals: int) -> int:
    out = 1
    for v in vals:
        out = out * v // math.gcd(out, v)
    return out


@dataclass(frozen=True)
class Geometry:
    """Every derived size of the signal chain (static at trace time)."""

    # input
    rx_ad_speed: int
    iq_input: bool
    channels: int
    timf1_sampling_speed: float   # complex sample rate after real->IQ fold

    # fft1
    fft1_n: int
    fft1_size: int
    fft1_interleave_points: int
    fft1_new_points: int
    fft1_interleave_ratio: float
    fft1_bandwidth: float
    fft1_sinpow: int

    # fft2 (0s when second FFT disabled)
    second_fft_enable: bool
    fft2_n: int
    fft2_size: int
    fft2_interleave_points: int
    fft2_new_points: int
    fft2_bandwidth: float
    fft2_sinpow: int

    # mix1 / timf3
    mix1_n: int
    mix1_size: int
    mix1_interleave_points: int
    mix1_new_points: int
    timf3_sampling_speed: float

    # fft3 / baseband
    fft3_n: int
    fft3_size: int
    fft3_interleave_points: int
    fft3_new_points: int
    fft3_sinpow: int
    mix2_size: int
    mix2_new_points: int
    baseband_sampling_speed: float

    # per-step batching
    samples_per_step: int         # complex input samples consumed per jitted step
    fft1_frames_per_step: int
    fft2_frames_per_step: int
    fftx_frames_per_step: int     # frames feeding mix1 (fft1 or fft2 stream)
    fft3_frames_per_step: int
    baseband_samples_per_step: int

    # blanker
    timf2_noise_floor_avgnum: int

    @property
    def fftx_size(self) -> int:
        """Size of the transform feeding mix1 (fft2 when enabled, else fft1).
        Reference: narrowband chain consumes fft2_float when SECOND_FFT_ENABLE
        (fft1def.h:242-330)."""
        return self.fft2_size if self.second_fft_enable else self.fft1_size

    @property
    def fftx_new_points(self) -> int:
        return self.fft2_new_points if self.second_fft_enable else self.fft1_new_points

    @property
    def fftx_interleave_points(self) -> int:
        return (self.fft2_interleave_points if self.second_fft_enable
                else self.fft1_interleave_points)

    @property
    def fftx_bandwidth(self) -> float:
        return self.fft2_bandwidth if self.second_fft_enable else self.fft1_bandwidth

    @property
    def decimation(self) -> int:
        """timf1 -> timf3 decimation factor (fftx_size / mix1_size)."""
        return self.fftx_size // self.mix1_size


def derive_geometry(p: RxParams) -> Geometry:
    """The get_wideband_sizes analog (reference buf.c:139-560)."""
    iq = p.input_mode == InputMode.IQ
    # Real input halves the effective complex rate (buf.c:47-51).
    timf1_speed = float(p.rx_ad_speed) * (1.0 if iq else 0.5)

    # ---- fft1 size from desired bandwidth (buf.c:168-199) ----
    r1 = interleave_ratio(p.first_fft_sinpow)
    if p.fft1_n_override:
        fft1_n = p.fft1_n_override
    else:
        if p.first_fft_bandwidth <= 0:
            bwfac = 65536
        else:
            bwfac = int(0.3536 * p.rx_ad_speed / ((1.0 - r1) * p.first_fft_bandwidth))
        j = bwfac
        if iq:
            j *= 2
        # round to power of two in (0.707*desired, 1.414*desired)
        fft1_n = 1
        i = max(j, 1)
        while j != 0:
            j //= 2
            fft1_n += 1
        if fft1_n < 7:
            fft1_n = 7
        if (1 << fft1_n) / i > 1.5:
            fft1_n -= 1
    if p.second_fft_enable and fft1_n > 15:
        fft1_n = 15  # buf.c:333 cap when second FFT in use
    fft1_size = 1 << fft1_n

    # interleave points forced even (buf.c:303-304)
    fft1_interleave = int(1 + r1 * fft1_size) & ~1
    fft1_bw = 0.5 * p.rx_ad_speed / ((1.0 - r1) * fft1_size)
    if iq:
        fft1_bw *= 2.0

    # ---- mix1 & fft2 geometry (buf.c:309-483) ----
    mix1_n = fft1_n - p.mix1_bandwidth_reduction_n
    if not p.second_fft_enable:
        mix1_n = max(mix1_n, 3)
        mix1_size = 1 << mix1_n
        mix1_interleave = int(r1 * mix1_size) & ~1
        # fft1 interleave adjusted to be an integer multiple of mix1's
        # (buf.c:325-327) so the decimated hop divides the wideband hop.
        fft1_interleave = mix1_interleave * (fft1_size // mix1_size)
        fft2_n = 0
        fft2_size = 0
        fft2_interleave = 0
        fft2_new = 0
        fft2_bw = 0.0
    else:
        # grow fft2 until fft2_bandwidth * 2^NINC < 1.5 * fft1_bandwidth
        # (buf.c:355-371)
        r2 = interleave_ratio(p.second_fft_sinpow)
        j = 1 << p.second_fft_ninc
        fft2_n = fft1_n
        while True:
            fft2_size = 1 << fft2_n
            fft2_bw = 0.5 * p.rx_ad_speed / ((1.0 - r2) * fft2_size)
            if iq:
                fft2_bw *= 2.0
            if fft2_bw * j < 1.5 * fft1_bw:
                break
            fft2_n += 1
        mix1_n += fft2_n - fft1_n
        mix1_n = max(mix1_n, 3)
        mix1_size = 1 << mix1_n
        mix1_interleave = int(r2 * mix1_size) & ~1
        # fft2 interleave snapped to a multiple of mix1's (buf.c:451-453)
        fft2_interleave = mix1_interleave * (fft2_size // mix1_size)
        fft2_new = fft2_size - fft2_interleave

    fft1_new = fft1_size - fft1_interleave
    fft1_ratio = fft1_interleave / fft1_size
    mix1_new = mix1_size - mix1_interleave

    fftx_size = fft2_size if p.second_fft_enable else fft1_size
    decim = fftx_size // mix1_size
    timf3_speed = timf1_speed * mix1_size / fftx_size  # buf.c:331,478-482

    # ---- fft3 / baseband (init_baseband_sizes analog) ----
    fft3_n = p.fft3_n
    fft3_size = 1 << fft3_n
    r3 = interleave_ratio(p.fft3_sinpow)
    fft3_interleave = int(1 + r3 * fft3_size) & ~1
    if p.fft3_sinpow == 2:
        fft3_interleave = fft3_size // 2  # exact 50% for sin^2 reconstruction
    fft3_new = fft3_size - fft3_interleave
    mix2_size = fft3_size >> p.mix2_reduction_n
    mix2_new = fft3_new >> p.mix2_reduction_n
    baseband_speed = timf3_speed * mix2_size / fft3_size

    # ---- per-step batching ----
    # samples_per_step must be a common multiple of every stage advance
    # mapped back to input samples so all per-step frame counts are ints.
    constraints = [fft1_new]
    if p.second_fft_enable:
        constraints.append(fft2_new)
    constraints.append(fft3_new * decim)  # fft3 hop in input-sample units
    base = _lcm(*constraints)
    # with time-sharding every per-shard chunk must also hold an integer
    # number of frames at every stage -> step is a multiple of base*shards
    base *= max(1, p.shards)
    mult = max(1, -(-p.target_fft1_frames_per_step * fft1_new // base))
    samples_per_step = base * mult

    n_fft1 = samples_per_step // fft1_new
    n_fft2 = samples_per_step // fft2_new if p.second_fft_enable else 0
    n_fftx = n_fft2 if p.second_fft_enable else n_fft1
    n_fft3 = samples_per_step // (fft3_new * decim)
    n_baseb = n_fft3 * mix2_new

    # blanker noise-floor time constant ~1 s (buf.c:336-341)
    nf_avg = max(1, int((p.rx_ad_speed + fft1_new / 2) / fft1_new))

    return Geometry(
        rx_ad_speed=p.rx_ad_speed,
        iq_input=iq,
        channels=p.rx_rf_channels,
        timf1_sampling_speed=timf1_speed,
        fft1_n=fft1_n,
        fft1_size=fft1_size,
        fft1_interleave_points=fft1_interleave,
        fft1_new_points=fft1_new,
        fft1_interleave_ratio=fft1_ratio,
        fft1_bandwidth=fft1_bw,
        fft1_sinpow=p.first_fft_sinpow,
        second_fft_enable=p.second_fft_enable,
        fft2_n=fft2_n,
        fft2_size=fft2_size,
        fft2_interleave_points=fft2_interleave,
        fft2_new_points=fft2_new,
        fft2_bandwidth=fft2_bw,
        fft2_sinpow=p.second_fft_sinpow,
        mix1_n=mix1_n,
        mix1_size=mix1_size,
        mix1_interleave_points=mix1_interleave,
        mix1_new_points=mix1_new,
        timf3_sampling_speed=timf3_speed,
        fft3_n=fft3_n,
        fft3_size=fft3_size,
        fft3_interleave_points=fft3_interleave,
        fft3_new_points=fft3_new,
        fft3_sinpow=p.fft3_sinpow,
        mix2_size=mix2_size,
        mix2_new_points=mix2_new,
        baseband_sampling_speed=baseband_speed,
        samples_per_step=samples_per_step,
        fft1_frames_per_step=n_fft1,
        fft2_frames_per_step=n_fft2,
        fftx_frames_per_step=n_fftx,
        fft3_frames_per_step=n_fft3,
        baseband_samples_per_step=n_baseb,
        timf2_noise_floor_avgnum=nf_avg,
    )
