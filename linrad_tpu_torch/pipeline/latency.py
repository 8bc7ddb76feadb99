"""Bounded-latency mode: the antenna-to-speaker budget (port of
linrad_tpu/pipeline/latency.py).

The reference optimises for interactive use: its documented total delay
example is 0.150 s (z_TIMING.txt:6-15) and it bounds the minimum
baseband delay as ``min_delay_time = fftx_size/(3*fs)`` capped at 0.1 s
(buf.c:500-509).  The throughput configurations batch thousands of
frames per step: great for file processing, useless for live
monitoring.  This module is the other operating point: a small-step
configuration plus the measurement that the end-to-end latency stays
inside the budget at a sustained rate.

Latency decomposition per step:

    total = block time        (samples_per_step / fs — the input wait)
          + processing time   (measured wall time of one step)
          + pipeline delay    (algorithmic group delay of the cascade)

The pipeline delay is the sum of each stage's carried overlap, all
expressed in input samples (the analog of the reference's per-buffer
delay accounting in the T-display, timing.c:55):

    fft1 analysis tail        fft1_interleave_points
    timf2 OLA completion      fft1_interleave_points      (second fft)
    fft2 analysis tail        fft2_interleave_points      (second fft)
    mix1 OLA tail             mix1_interleave * (fftx/mix1)
    fft3 analysis tail        fft3_interleave * decim
    mix2 OLA tail             (mix2 interleave) * decim2

An impulse fed through the real chain comes out at the analytic sum to
within one mix2 output frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry import Geometry, derive_geometry
from ..params import RxParams

BUDGET_S = 0.150   # z_TIMING.txt:6-15 documented example total


def pipeline_delay_samples(geo: Geometry) -> float:
    """Algorithmic group delay of the cascade in input samples."""
    fs = geo.timf1_sampling_speed
    d = float(geo.fft1_interleave_points)
    if geo.second_fft_enable:
        d += geo.fft1_interleave_points          # timf2 OLA completion
        d += geo.fft2_interleave_points          # fft2 analysis tail
    decim = geo.fftx_size // geo.mix1_size
    d += geo.mix1_interleave_points * decim      # mix1 OLA tail
    decim2 = fs / geo.timf3_sampling_speed
    d += (geo.fft3_size - geo.fft3_new_points) * decim2  # fft3 tail
    d += ((geo.mix2_size - geo.mix2_new_points)          # mix2 OLA tail
          * fs / geo.baseband_sampling_speed)
    return d


def latency_params(rx_ad_speed: int = 96_000,
                   second_fft: bool = False, **overrides) -> RxParams:
    """A configuration tuned for bounded latency: small fft1, shallow
    decimation, small baseband FFT, and a step short enough that block
    time + pipeline delay fit the 0.150 s budget with headroom for
    processing."""
    kw = dict(
        rx_ad_speed=rx_ad_speed,
        fft1_n_override=10,
        mix1_bandwidth_reduction_n=3,
        fft3_n=8,
        mix2_reduction_n=0,
        second_fft_enable=second_fft,
        blanker_enable=second_fft,
        agc_enable=True,
        target_fft1_frames_per_step=8,
    )
    kw.update(overrides)
    return RxParams(**kw)


def measure_latency(params: RxParams, steps: int = 100,
                    warmup: int = 5, *, device="cuda") -> dict:
    """Run the single-step chain and report the latency budget.

    Returns {block_ms, proc_ms_p50, proc_ms_p95, pipeline_ms, total_ms,
    budget_ms, within_budget, sustained}: ``sustained`` is true when
    the p95 processing time fits inside one block time (the chain keeps
    up with the A/D indefinitely), ``within_budget`` when
    block + p95 + pipeline fits the 0.150 s reference budget.

    On a CUDA device the step runs as a captured graph
    (:class:`.batch.GraphedStep`), the counterpart of the JAX function's
    jitted step; on ``device="cpu"`` eagerly."""
    from .batch import GraphedStep
    from .chain import RxState, RxTables, make_rx_step
    from .receiver import _pulsewidth, resolve_device

    dev = resolve_device(device)
    geo = derive_geometry(params)
    fs = geo.timf1_sampling_speed
    tables = RxTables.create(geo, params, dev)
    state = RxState.create(geo, dev)
    step = make_rx_step(geo, params, blanker_pulsewidth=_pulsewidth(geo))
    rng = np.random.default_rng(0)
    n = geo.samples_per_step
    sig = (0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
           ).astype(np.complex64)
    tune = torch.full((), 64, dtype=torch.int64, device=dev)
    graphed = GraphedStep(step, tables, state, (n, geo.channels),
                          torch.complex64, (tune,))
    out = graphed(torch.from_numpy(sig[:, None]).to(dev))
    for _ in range(warmup):
        out = graphed()
    # latency is timed through the audio actually ARRIVING on the host,
    # not through the step having been enqueued: a live consumer fetches
    # every block
    out.audio.cpu()                       # warm the fetch path
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = graphed()
        out.audio.cpu()
        times.append(time.perf_counter() - t0)
    times = np.array(times)
    block_ms = 1e3 * n / fs
    pipe_ms = 1e3 * pipeline_delay_samples(geo) / fs
    p50 = 1e3 * float(np.percentile(times, 50))
    p95 = 1e3 * float(np.percentile(times, 95))
    total = block_ms + p95 + pipe_ms
    return {
        "block_ms": round(block_ms, 2),
        "proc_ms_p50": round(p50, 2),
        "proc_ms_p95": round(p95, 2),
        "pipeline_ms": round(pipe_ms, 2),
        "total_ms": round(total, 2),
        "budget_ms": round(1e3 * BUDGET_S, 1),
        "within_budget": bool(total <= 1e3 * BUDGET_S),
        "sustained": bool(p95 <= block_ms),
    }
