"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA, print the card, its power limit, the torch and
            CUDA versions; turn TF32 off for matmul and cuDNN.
2. build    build the fused fft1 kernel from linrad_tpu_torch/csrc/ with
            nvcc (sm_90a) and print the build seconds.
3. kernel   fused_fft1 (kernel) against fused_fft1_reference (plain
            PyTorch) on the card at eight shapes, the flagship's and the
            EME path's among them, and three that reach the kernel's
            other ways (several frames a block with a ragged end, more
            than two channels); max_rel <= 1e-5 for spectrum and power
            sum; two runs on the same input give the same bits.  Times per
            shape: eager calls between CUDA events (ms, plain_ms: the
            host's enqueue cost included), and device-only time of the
            same calls captured into a CUDA graph and replayed
            (device_ms, plain_device_ms), beside the bound from the bytes
            the function must move (bound_ms), torch.fft.fft alone timed
            the same way (library_ms: the transform without window,
            calibration or power; a yardstick the port never calls) and
            one empty kernel launch (launch_floor_ms).
4. main     the flagship receive step (96 kHz IQ, 65,536 samples per
            step, fft1 2048 with the kernel) through Receiver for 8 steps
            of a weak keyed CW tone, Gaussian noise, impulse noise and a
            strong carrier; the kernel's launch count must rise by one per
            step; the same input through a Receiver on torch.fft
            ("xla") must agree within the stated bars.
5. timing   step time and complex Msamples/s for both receivers.
6. eme      the EME configuration (48 kHz two-channel IQ, WCW preset:
            adaptive polarization, coherent CW detection, AFC with drift
            tracking; fft1 4096 with the kernel at (64, 4096, 2)) through
            Receiver for 12 steps of a keyed CW tone drifting 0.05 Hz/s,
            polarized 0.8 : 0.6j across the channels, with Gaussian noise,
            impulse noise and a strong carrier; one kernel launch per
            step; the AFC reaches status 3 and hands the step per-frame
            tune_slope tensors; the audio peak is at the 600 Hz BFO; the
            polarization weights point along the injected polarization;
            a torch.fft ("xla") receiver gives the same AFC trajectory,
            blanker counts and liminfo signs, and the same fields within
            the stated bars.  A direct make_rx_step call with per-frame
            (bins, frac, slope) on the card makes no host synchronisation.
7. eme timing  step time with the Receiver (the AFC's one device-to-host
            read of fft2_power per step) and with the bare step on fixed
            per-frame tuning, in turns.

8. multi    the flagship configuration with spur cancellation, squelch
            and expander through MultiReceiver with 24 sub-receivers (the
            reference's MIX1_NO_OF_CHANNELS) on the default device, 10
            steps of the flagship input plus a weak keyed tone on each of
            the 24 dials; the spur manager (WeakSignalControl) scans every
            second step.  One kernel launch per step; a spur slot holds
            the strong carrier's fft2 bin; fft2_power there falls by more
            than 20 dB against the same run without spur cancellation
            while the 24 dial bins stay within 3 dB; every sub-receiver's
            audio peaks at the BFO pitch; three sub-receivers equal a
            single Receiver on the same dial (baseb <= 1e-4); a torch.fft
            ("xla") MultiReceiver gives the same slot bins, blanker counts
            and liminfo signs and the same fields within the bars.  Prints
            step time and rate at K = 1 and K = 24 in turns, the device
            operations per step at both from torch.profiler, and the
            control's host reads.
9. real     real input at full width (192 kHz real samples, the same 96
            kHz timf1 rate, fft1 2048, fft2 4096), mixer mode 2 and the
            audio resampler at twice the baseband rate through Receiver
            for 6 steps: a real tone on the dial comes out at the BFO
            pitch at the resampled rate, no kernel launch (the JAX
            package's dispatch takes torch.fft for real input); then 3
            steps of IQ input with an I/Q correction table, no launch
            either.

10. batch   BatchRunner(k_steps=8) on the default device over 16 steps of
            the flagship input: the step captured into a CUDA graph and
            replayed, against the same step run eagerly in a loop (audio
            and baseb bit-equal); 16 kernel launches, counted per replay;
            a fresh runner gives the same bits; a torch.fft ("xla") runner
            within phase 4's bars; a call makes no host synchronisation
            between its steps.  Then times in turns (eager, graph, graph,
            eager): ms per step and complex Msamples/s for whole calls,
            the replays alone, capture seconds and the graph pool's bytes,
            and from torch.profiler over one call what the host enqueues,
            that the device ran the kernel once per replay, and the
            device time beside the wall time.
11. checkpoint  the flagship Receiver: 4 steps, save, load into a new
            Receiver, 4 more; every output field of steps 5-8 equals an
            uninterrupted run's bit for bit.  The same on the EME
            configuration, saved once the AFC has its signal: AFC status,
            frame bins and tune_slope continue exactly.
12. file    8 flagship steps written to a 16-bit IQ WAV with an rcvr
            chunk and replayed with Receiver.run_file through the native
            prefetcher (the C++ library must have loaded): the centre
            frequency read back, the audio equal to run() on the rounded
            samples bit for bit, 8 kernel launches.
13. latency measure_latency on the bounded-latency configuration, without
            and with the second FFT, the step as a CUDA graph: prints the
            budget; pipeline_ms must equal the analytic value.
14. radar, wfm  frame_pulse_stats, a RadarTracker's lock and
            wfm_stereo_decode on the card against the same on the CPU
            (peak bins and every decision exact, floats 1e-5), and the
            stereo round trip (separation over 25 dB, pilot found).

15. rounds  the flagship with blanker_rounds=8 (the round-parallel clever
            blanker) on phase 4's input: Receiver for 8 steps (one launch
            a step; against a torch.fft receiver to phase 4's bars, counts
            exact), then BatchRunner(k_steps=8) from a CUDA graph for 16
            steps, bit-equal to the same step run eagerly.  Fits per step
            beside the sequential blanker's; device kernels per step
            (torch.profiler) and ms per step of the replays, in turns with
            the same runner at blanker_rounds=0.
16. mxu     the flagship with fft1_variant "mxu" (the four-step matmul DFT,
            2048 = 32 x 64, in float32) for 8 steps against the "xla"
            receiver to phase 4's bars; the same run once more with TF32
            switched on by this script gives the same bits; "mxu_bf16"
            against the same variant run on the CPU, to phase 4's bars,
            and what it reaches against "xla".  No kernel launch on these
            paths: the JAX package's dispatch takes no Pallas kernel
            there either.
17. calibration  the flagship with a filtercorr from
            calibration.make_filtercorr of a tilted, rippled response:
            the kernel receiver against the torch.fft one, phase 4's bars.
18. fleet   FleetRunner(flagship, n_streams=8, k_steps=8) for 16 steps, each
            stream a keyed tone on its own dial over phase 4's carrier,
            noise and impulses, with vmap's slow-path warning an error
            (no operation loops over the streams): one kernel launch per
            step for the eight streams (the fused fft1's vmap rule folds
            them into its channel axis, (64, 2048, 8)); three streams
            against a single Receiver on the same dial, phase 4's bars; ms
            per step and aggregate complex Msamples/s at R = 1 and R = 8 in
            turns, the graph pools, the stream fold's copy alone.

``python3 chip_smoke.py --stages`` runs phases 1 and 2 and then, instead
of the smoke run, a diagnostic: the synced wall time of every stage of
the multi-receiver step at K = 24 and K = 1.  ``--regimes`` likewise
prints the graphed flagship step's time at points of one process's life
(a fresh runner, after the profiler's first start, after another capture,
after an eager loop).

It prints a JSON line describing every kernel of the paths (launches
summed over the flagship, EME, multi-receiver, real-input, batch,
checkpoint, file, rounds, mxu, calibration and fleet runs, each counted
from zero; times
at the flagship's shape, and per shape under "by_shape"), then, as the
last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

STEPS = 8
KERNEL_SHAPES = [(3, 128, 1), (40, 512, 2), (64, 2048, 1), (2048, 2048, 1),
                 (64, 4096, 2),
                 # the fleet's eight flagship streams folded into channels
                 (64, 2048, 8),
                 # the kernel's other ways: three frames a block with a
                 # ragged end, channels in pairs and singly along grid y
                 (1100, 2048, 1), (9, 1024, 4), (5, 256, 3)]
MAIN_SHAPE = (64, 2048, 1)
KERNEL_TOL = 1e-5
# published peaks of one H100 SXM at its full power limit of 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# pallas (kernel) vs xla (torch.fft) receivers on the card
CHAIN_TOL = {"audio": 1e-4, "fft2_power": 1e-5, "liminfo": 1e-5}
CHAIN_TOL_OTHER = 1e-4
# Step 0 holds the chain's start-up: the output ramps up from the
# zero-initialised tails while the AGC gain is still ~40x its settled
# value, so fp32 roundoff (whose absolute size the strong carrier sets)
# reaches the audio ~40x amplified.  Measured 5.5e-4 on an H100; every
# other field, and audio from step 1 on, is held to the bars above.
START_AUDIO_TOL = 1e-3
# The multi-receiver path in step 0: the worst of 24 sub-receivers, and
# the expander (exponent 2) squares the audio under the AGC's reference
# level, which doubles its relative error.  Measured on an H100: audio
# 1.9e-3, agc_gain 3.2e-4; from step 1 on 3.4e-5 and 1.1e-5.
MULTI_START_TOL = {"audio": 4e-3, "agc_gain": 1e-3}
TUNE_HZ = 12_345.6
CARRIER_HZ = -21_000.0
# the EME path
EME_STEPS = 12
EME_TIME_STEPS = 8
EME_TUNE_HZ = 1_000.0
EME_POL = np.array([0.8, 0.6j])
EME_BFO_HZ = 600.0
# the multi-receiver and real-input paths
MULTI_K = 24
MULTI_STEPS = 10
MULTI_TIME_STEPS = 6
# The dial tones must open the squelch (in-band power over 4 times the
# quietest bins': amplitude^2 * duty > 13 beside noise of 10 a component)
# and stay below what sellim calls strong (amplitude^2 * duty < 32), so
# that the front end does not depend on which dial it protects.
MULTI_TONE_AMPLITUDE = 6.6
# A steady carrier on an fft2 bin centre, weak enough that sellim does not
# limit it (amplitude^2 < 32): the spur whose cancellation depth is held
# to 20 dB.  The 2000-amplitude carrier reaches fft2 limited to 26 dB over
# the noise, re-shaped by the limiter's per-bin gains.
MULTI_SPUR_HZ = 30_000.0
MULTI_SPUR_AMPLITUDE = 4.5
BFO_HZ = 800.0
REAL_STEPS = 6
# the host layer
BATCH_K = 8
BATCH_STEPS = 16
FILE_STEPS = 8
# the round-parallel blanker, the fleet
ROUNDS = 8
FLEET_R = 8
FLEET_K = 8
FLEET_STEPS = 16
FLEET_FIELDS = ("audio", "baseb")
# the start of the warning torch.func.vmap gives where an operation has no
# batching rule and it loops over the batch instead
VMAP_SLOW_PATH = "There is a performance drop"


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max(max|a|, max|b|), in double precision."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    a = a.detach().to(wide)
    b = b.detach().to(wide)
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return (a - b).abs().max().item() / scale


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is still on for cuBLAS or cuDNN")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0), "smi": smi,
           "count": torch.cuda.device_count()}
    print(f"device: {dev['name']} (count {dev['count']}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    print(smi)
    return dev


def phase_build() -> None:
    from linrad_tpu_torch.ops import fused_fft1 as ff
    t0 = time.perf_counter()
    _, info = ff.build()
    print(f"build: {info['path']} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['build_seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if any(w in line for w in ("registers", "smem", "spill", "error")):
            print(f"  ptxas: {line.strip()}")


def phase_kernel(dev: dict) -> dict:
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.ops.fused_fft1 import (fused_fft1,
                                                 fused_fft1_reference)
    from linrad_tpu_torch.utils.timing import cuda_ms, graph_ms
    before = fused_fft1.launches
    cuda = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    print(f"kernel launch floor: one empty kernel {floor:.5f} ms "
          f"(device-only, CUDA graph) [{dev['smi']}]")
    report = {}
    for b, n, c in KERNEL_SHAPES:
        rng = np.random.default_rng(7)
        frames = torch.from_numpy(
            (rng.normal(size=(b, n, c)) + 1j * rng.normal(size=(b, n, c))
             ).astype(np.complex64)).cuda()
        window = torch.from_numpy((np.sin(np.pi * (np.arange(n) + 0.5) / n)
                                   ** 2).astype(np.float32)).cuda()
        fc = torch.from_numpy(
            ((rng.normal(size=(n, c)) + 1j * rng.normal(size=(n, c))) * 0.1
             ).astype(np.complex64)).cuda()

        def kernel():
            return fused_fft1(frames, window, fc)

        def plain():
            return fused_fft1_reference(frames, window, fc)

        def library():
            return torch.fft.fft(frames, dim=1)

        spec_k, pow_k = kernel()
        spec_r, pow_r = plain()
        spec_2, pow_2 = kernel()
        torch.cuda.synchronize()
        rel_s = max_rel(spec_k, spec_r)
        rel_p = max_rel(pow_k, pow_r)
        abs_err = max((spec_k - spec_r).abs().max().item(),
                      (pow_k - pow_r).abs().max().item())
        same_bits = (torch.equal(torch.view_as_real(spec_k),
                                 torch.view_as_real(spec_2))
                     and torch.equal(pow_k, pow_2))
        plan = ff.launch_plan(b, n, c, sms)
        print(f"kernel fused_fft1 {(b, n, c)}: spec max_rel {rel_s:.3e}, "
              f"power_sum max_rel {rel_p:.3e}, max_abs_err {abs_err:.3e}; "
              f"two runs bit-identical: {same_bits}; plan: grid "
              f"{plan['grid']} x {plan['threads']} threads, "
              f"{plan['frames_per_block']} frame(s) per block, "
              f"{plan['smem_bytes']} B shared, {plan['clusters']} scratch "
              f"row(s), radices {plan['radices']}")
        if not (rel_s <= KERNEL_TOL and rel_p <= KERNEL_TOL):
            raise AssertionError(f"fused_fft1 {(b, n, c)} disagrees with "
                                 f"its plain version: {rel_s}, {rel_p}")
        if not same_bits:
            raise AssertionError(f"fused_fft1 {(b, n, c)}: two runs on the "
                                 f"same input differ")
        reps = 50 if b * n <= 1 << 17 else 10
        for _ in range(3):
            kernel()
            plain()
        plain_ms = cuda_ms(plain, reps)
        kern_ms = cuda_ms(kernel, reps)
        kern_ms = 0.5 * (kern_ms + cuda_ms(kernel, reps))
        plain_ms = 0.5 * (plain_ms + cuda_ms(plain, reps))
        replays = 20 if b * n <= 1 << 17 else 5
        lib_dev = graph_ms(library, reps, replays)
        kern_dev = graph_ms(kernel, reps, replays)
        plain_dev = graph_ms(plain, reps, replays)
        kern_dev = 0.5 * (kern_dev + graph_ms(kernel, reps, replays))
        lib_dev = 0.5 * (lib_dev + graph_ms(library, reps, replays))
        by_bytes = 1e3 * ff.necessary_bytes(b, n, c) / PEAK_BYTES_PER_S
        by_ops = 1e3 * ff.operations(b, n, c) / PEAK_FP32_OPS_PER_S
        bound = max(by_bytes, by_ops)
        print(f"kernel fused_fft1 {(b, n, c)} times: device_ms "
              f"{kern_dev:.5f}, eager ms {kern_ms:.4f}, bound_ms "
              f"{bound:.5f} ({ff.necessary_bytes(b, n, c)} bytes; by "
              f"operations {by_ops:.5f}), share of bound "
              f"{bound / kern_dev:.3f}, library_ms (torch.fft.fft alone) "
              f"{lib_dev:.5f}, plain eager ms {plain_ms:.4f}, plain "
              f"device_ms {plain_dev:.5f}, launch_floor_ms {floor:.5f} "
              f"[{dev['smi']}]")
        report[(b, n, c)] = {
            "max_abs_err": abs_err, "ms": kern_ms, "plain_ms": plain_ms,
            "device_ms": kern_dev, "plain_device_ms": plain_dev,
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": lib_dev, "launch_floor_ms": floor}
    if fused_fft1.launches <= before:
        raise AssertionError("fused_fft1 launch counter did not rise")
    return report


def make_input(geo, seed: int = 0, steps: int = STEPS, tones=(TUNE_HZ,),
               tone_amplitude: float = 10.0, spur=None) -> np.ndarray:
    """steps steps of: a weak on/off-keyed CW tone at each frequency of
    ``tones`` (the dial frequency TUNE_HZ: the BFO puts it at 800 Hz
    audio), complex Gaussian noise, impulse noise, a strong carrier and,
    with ``spur`` = (Hz, amplitude), a weak steady one."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 2).astype(np.float64)   # 60 ms elements
    tone = np.zeros(n, np.complex128)
    # several tones: each with its own phase and keying offset, or their
    # sum would be a pulse train that the blankers take for impulse noise
    trng = np.random.default_rng(seed + 1000)
    for f in tones:
        if len(tones) > 1:
            shift = int(trng.integers(0, int(0.24 * fs)))
            phase = np.exp(2j * np.pi * trng.uniform())
            tone += tone_amplitude * phase * np.roll(key, shift) \
                * np.exp(2j * np.pi * f * t)
        else:
            tone += tone_amplitude * key * np.exp(2j * np.pi * f * t)
    carrier = 2000.0 * np.exp(2j * np.pi * CARRIER_HZ * t + 0.3j)
    if spur is not None:
        carrier += spur[1] * np.exp(2j * np.pi * spur[0] * t + 1.1j)
    noise = 10.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    imp = np.zeros(n, np.complex128)
    pos = rng.integers(0, n, size=steps * max(8, geo.samples_per_step // 1600))
    imp[pos] = 3000.0 * np.exp(2j * np.pi * rng.uniform(size=pos.size))
    return (tone + carrier + noise + imp).astype(np.complex64)[:, None]


def run_rx(p, iq: np.ndarray, device, calibration=None,
           tune_hz: float = TUNE_HZ) -> list:
    """A Receiver on ``device`` tuned to ``tune_hz`` over every step of
    iq; the outputs after the device has finished."""
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, calibration, device=device)
    rx.tune(tune_hz)
    outs = list(rx.run(iq))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return outs


def phase_main() -> int:
    """Returns the kernel's launch count over the main path's steps."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    geo = derive_geometry(flagship_params())
    iq = make_input(geo)
    fused_fft1.launches = 0
    outs = run_rx(flagship_params(fft1_variant="pallas"), iq, "cuda")
    launches = fused_fft1.launches
    print(f"main path: {len(outs)} steps of {geo.samples_per_step} samples, "
          f"fused_fft1 launches {launches}")
    if launches != STEPS or len(outs) != STEPS:
        raise AssertionError(f"expected {STEPS} kernel launches (one per "
                             f"step), saw {launches}")
    shapes = flagship_shapes(geo)
    check_outputs(outs, shapes)
    fitted = [int(o.blanker_fitted) for o in outs]
    cleared = [int(o.blanker_cleared) for o in outs]
    strong = [int((o.liminfo != 0).sum()) for o in outs]
    print(f"blanker_fitted {fitted}; blanker_cleared {cleared}; liminfo "
          f"non-zero bins {strong}")
    if max(fitted) == 0 or max(strong) == 0:
        raise AssertionError("the blanker fitted nothing or liminfo has no "
                             "strong bins: the comparison would be vacuous")
    audio = torch.cat([o.audio for o in outs])[:, 0].double().cpu().numpy()
    spec = np.abs(np.fft.rfft(audio)) ** 2
    peak_hz = np.argmax(spec[1:]) + 1
    peak_hz = peak_hz * geo.baseband_sampling_speed / audio.size
    print(f"audio spectrum peak at {peak_hz:.1f} Hz (keyed tone expected at "
          f"the 800 Hz BFO offset)")
    if abs(peak_hz - 800.0) > 20.0:
        raise AssertionError("the keyed CW tone is not at the BFO offset")

    compare_runs(outs, run_rx(flagship_params(fft1_variant="xla"), iq,
                              "cuda"), shapes, "")
    return launches


def flagship_shapes(geo, lead: tuple = ()) -> dict:
    """Every RxOutputs field's shape on the flagship configuration."""
    bb = geo.baseband_samples_per_step
    return {"audio": lead + (bb, 1), "baseb": lead + (bb, 1),
            "fft1_power": (geo.fft1_size, 1),
            "fft1_avg_power": (geo.fft1_size, 1),
            "agc_gain": lead + (bb, 1), "fft2_power": (geo.fft2_size, 1),
            "liminfo": (geo.fft1_size,), "blanker_fitted": (),
            "blanker_cleared": (), "noise_floor": ()}


def check_outputs(outs: list, shapes: dict) -> None:
    """Every field of every step has its shape and finite values."""
    for i, out in enumerate(outs):
        for k, shape in shapes.items():
            v = getattr(out, k)
            if tuple(v.shape) != shape:
                raise AssertionError(f"step {i} {k}: shape "
                                     f"{tuple(v.shape)} != {shape}")
            if not torch.isfinite(v).all().item():
                raise AssertionError(f"step {i} {k}: non-finite values")


def compare_runs(outs: list, ref: list, keys, label: str,
                 start_tol: dict | None = None,
                 what: str = "pallas vs xla on the card") -> None:
    """The receiver through the kernel (outs) against the receiver through
    torch.fft (ref), or the two receivers ``what`` names: blanker counts
    and the liminfo sign pattern exact in every step, each float field
    within its bar (step 0's audio within START_AUDIO_TOL, or step 0's
    fields within ``start_tol``)."""
    start_tol = start_tol or {"audio": START_AUDIO_TOL}
    # worst max_rel per field: over the start-up step, and over the rest
    start, steady = {}, {}
    for i, (a, b) in enumerate(zip(outs, ref)):
        for k in keys:
            va, vb = getattr(a, k), getattr(b, k)
            if k in ("blanker_fitted", "blanker_cleared"):
                if int(va) != int(vb):
                    raise AssertionError(f"{label}step {i} {k}: {int(va)} "
                                         f"!= {int(vb)}")
                continue
            if k == "liminfo" and not torch.equal(torch.sign(va),
                                                  torch.sign(vb)):
                raise AssertionError(f"{label}step {i}: liminfo sign "
                                     f"pattern differs")
            worst = start if i == 0 else steady
            worst[k] = max(worst.get(k, 0.0), max_rel(va, vb))
    failed = []
    for span, worst in (("step 0", start),
                        (f"steps 1-{len(outs) - 1}", steady)):
        for k, v in worst.items():
            bar = CHAIN_TOL.get(k, CHAIN_TOL_OTHER)
            if span == "step 0":
                bar = start_tol.get(k, bar)
            print(f"{label}{what}, {span}: {k} max_rel {v:.3e} (bar {bar})")
            if v > bar:
                failed.append(f"{label}{span} {k}: max_rel {v} > {bar}")
    if failed:
        raise AssertionError("; ".join(failed))
    print(f"{label}{what}: liminfo sign pattern and blanker counts exact "
          f"in every step")


def phase_timing(dev: dict) -> None:
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.pipeline.receiver import Receiver
    geo = derive_geometry(flagship_params())
    iq = make_input(geo, seed=1)
    blocks = [iq[i * geo.samples_per_step:(i + 1) * geo.samples_per_step]
              for i in range(STEPS)]
    for variant in ("pallas", "xla", "xla", "pallas"):
        rx = Receiver(flagship_params(fft1_variant=variant), device="cuda")
        rx.tune(TUNE_HZ)
        dev_blocks = [torch.from_numpy(b).cuda() for b in blocks]
        for b in dev_blocks[:2]:
            rx.process_block(b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for b in dev_blocks:
            rx.process_block(b)
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(dev_blocks)
        print(f"timing {variant}: {ms:.3f} ms/step (CUDA events), host "
              f"enqueue {1e3 * host_s / len(dev_blocks):.3f} ms/step, "
              f"{geo.samples_per_step / ms / 1e3:.3f} complex Msamples/s "
              f"[{dev['smi']}]")
        # one more step, untimed: any host<->device synchronisation
        # inside the step raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            rx.process_block(dev_blocks[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print("timing: a step on device input makes no host synchronisation")


def eme_params(fft1_variant: str, **overrides):
    """The EME configuration: the WCW preset (second FFT, both blankers,
    coherent CW detection mode 2, AFC) on a 48 kHz X/Y antenna pair with
    adaptive polarization.  ``overrides`` cut it to size for a rehearsal
    on the CPU."""
    from linrad_tpu_torch import RxMode, preset
    return preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,
                  pol_adapt_enable=True, fft1_variant=fft1_variant,
                  **overrides)


def make_eme_input(geo, steps: int, seed: int = 3) -> np.ndarray:
    """steps steps of two-channel IQ: a keyed CW tone 5 Hz above the dial
    drifting 0.05 Hz/s, polarized EME_POL across the channels; complex
    Gaussian noise; a strong carrier at -15 kHz (liminfo strong bins);
    impulses of amplitude 300 (the blankers' work)."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = steps * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 3).astype(np.float64)
    phase = 2 * np.pi * np.cumsum(EME_TUNE_HZ + 5.0 + 0.05 * t) / fs
    x = (key * np.exp(1j * phase))[:, None] * EME_POL[None, :]
    x = x + rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    x = x + (100.0 * np.exp(2j * np.pi * -15_000.0 * t + 0.3j)[:, None]
             * np.array([1.0, 0.5]))
    k = max(12, geo.samples_per_step // 3200)
    for s in range(steps):
        pos = s * geo.samples_per_step + rng.integers(
            0, geo.samples_per_step, k)
        x[pos] += (300.0 * np.exp(2j * np.pi * rng.uniform(size=(k, 1)))
                   * np.array([1.0, 0.7]))
    return x.astype(np.complex64)


def run_eme(p, iq: np.ndarray, device: str) -> tuple:
    """Receiver tuned to the dial over EME_STEPS steps of iq.  Returns
    (receiver, outputs, AFC trajectory: (status, freq_hz, tune bins) per
    step)."""
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, device=device)
    rx.tune(EME_TUNE_HZ)
    s = rx.geo.samples_per_step
    outs, track = [], []
    for i in range(EME_STEPS):
        outs.append(rx.process_block(iq[i * s:(i + 1) * s]))
        track.append((rx.afc.status, rx.afc.freq_hz,
                      rx._tune_bin.cpu().numpy()))
    return rx, outs, track


def phase_eme(device: str = "cuda", **overrides) -> tuple:
    """The EME path on the card.  Returns (kernel launches over its
    EME_STEPS steps, the receiver, the input, which holds EME_TIME_STEPS
    more steps for the timing phase)."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.chain import make_rx_step
    p = eme_params("pallas", **overrides)
    geo = derive_geometry(p)
    iq = make_eme_input(geo, EME_STEPS + EME_TIME_STEPS)
    fused_fft1.launches = 0
    rx, outs, track = run_eme(p, iq, device)
    launches = fused_fft1.launches
    print(f"eme path: {len(outs)} steps of {geo.samples_per_step} samples "
          f"x {geo.channels} channels, fft1 {geo.fft1_size} "
          f"({geo.fft1_frames_per_step} frames), fused_fft1 launches "
          f"{launches}, fft2_power host reads {rx.control.host_reads}")
    if launches != EME_STEPS:
        raise AssertionError(f"expected {EME_STEPS} kernel launches (one "
                             f"per step), saw {launches}")
    if rx.control.host_reads != EME_STEPS:
        raise AssertionError("expected one fft2_power read per step")
    bb = geo.baseband_samples_per_step
    shapes = {"audio": (bb, 1), "baseb": (bb, 1),
              "fft1_power": (geo.fft1_size, 2),
              "fft1_avg_power": (geo.fft1_size, 2),
              "agc_gain": (bb, 1), "fft2_power": (geo.fft2_size, 2),
              "liminfo": (geo.fft1_size,),
              "blanker_fitted": (), "blanker_cleared": (),
              "noise_floor": ()}
    check_outputs(outs, shapes)
    fitted = [int(o.blanker_fitted) for o in outs]
    cleared = [int(o.blanker_cleared) for o in outs]
    strong = [int((o.liminfo != 0).sum()) for o in outs]
    print(f"eme: blanker_fitted {fitted}; blanker_cleared {cleared}; "
          f"liminfo non-zero bins {strong}")
    if max(fitted) == 0 or max(strong) == 0:
        raise AssertionError("eme: the blanker fitted nothing or liminfo "
                             "has no strong bins: the comparison would be "
                             "vacuous")

    statuses = [t[0] for t in track]
    slope = rx._tune_slope
    print(f"eme: AFC status per step {statuses}; freq_hz "
          f"{[round(t[1], 3) for t in track]}; tune_slope "
          f"{None if slope is None else tuple(slope.shape)} on "
          f"{None if slope is None else slope.device}")
    n = geo.fftx_frames_per_step
    if 3 not in statuses:
        raise AssertionError("eme: the AFC never reached status 3")
    if (slope is None or tuple(slope.shape) != (n,)
            or slope.device.type != torch.device(device).type):
        raise AssertionError("eme: tune_slope is not a per-frame tensor on "
                             "the device")

    audio = torch.cat([o.audio for o in outs])[:, 0].double().cpu().numpy()
    spec = np.abs(np.fft.rfft(audio)) ** 2
    peak_hz = ((np.argmax(spec[1:]) + 1) * geo.baseband_sampling_speed
               / audio.size)
    print(f"eme: audio spectrum peak at {peak_hz:.2f} Hz (BFO "
          f"{EME_BFO_HZ} Hz)")
    if abs(peak_hz - EME_BFO_HZ) > 20.0:
        raise AssertionError("eme: the CW tone is not at the BFO offset")

    from linrad_tpu_torch.weak.pol import pol_info
    coh = rx.state.pol.coherency.cpu().numpy()
    w = np.linalg.eigh(coh)[1][:, -1]
    overlap = abs(np.vdot(w, EME_POL)) / np.linalg.norm(EME_POL)
    info = pol_info(rx.state.pol)
    print(f"eme: polarization weights {np.round(w, 4).tolist()}, "
          f"|<v, v_true>| {overlap:.5f}; tilt {info.tilt_deg:.2f} deg, "
          f"axial ratio {info.axial_ratio_db:.2f} dB, coherence "
          f"{info.coherence:.4f}")
    if overlap < 0.95:
        raise AssertionError("eme: the polarization weights miss the "
                             "injected polarization")

    _, ref, ref_track = run_eme(eme_params("xla", **overrides), iq, device)
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    for i, (a, b) in enumerate(zip(track, ref_track)):
        if (a[0] != b[0] or not np.array_equal(a[2], b[2])
                or abs(a[1] - b[1]) > 1e-3 * bin_hz):
            raise AssertionError(f"eme step {i}: AFC trajectory differs "
                                 f"from the xla receiver's: {a} != {b}")
    print("eme: pallas vs xla AFC trajectory exact (status, frame bins; "
          "freq_hz within 1e-3 bin) in every step")
    # Once the AFC tracks, the two receivers' fractional tuning differs by
    # about one float32 ulp (their fft2_power differs by ~1e-7), and the
    # mix1 ramp integrates that into a baseband phase drift that grows
    # with the step count: baseb reached 7.7e-5 at step 11 on an H100
    # (1.5e-5 with each step's common phase removed); the audio, after
    # the coherent detector removes the carrier phase, 4.9e-6.
    compare_runs(outs, ref, shapes, "eme: ")

    if torch.device(device).type == "cuda":
        # the bare step with the AFC's per-frame tuning already on the
        # device: any host<->device synchronisation inside it raises
        step = make_rx_step(geo, p, rx.blanker_pulsewidth,
                            fractional_tune=True)
        s = geo.samples_per_step
        block = torch.from_numpy(iq[:s]).cuda()
        tune = (rx._tune_bin, rx._tune_frac, rx._tune_slope)
        step(rx.tables, rx.state, block, *tune)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(rx.tables, rx.state, block, *tune)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("eme: a direct make_rx_step call with per-frame (bins, frac, "
              "slope) on the card makes no host synchronisation")
    return launches, rx, iq


def phase_eme_timing(dev: dict, rx, iq: np.ndarray) -> None:
    """EME step time in turns: through Receiver.process_block (the AFC's
    fft2_power read to the host every step) and the bare step with the
    AFC's last per-frame tuning held fixed (no host read)."""
    from linrad_tpu_torch.pipeline.chain import make_rx_step
    s = rx.geo.samples_per_step
    blocks = [torch.from_numpy(iq[(EME_STEPS + i) * s:
                                  (EME_STEPS + i + 1) * s]).cuda()
              for i in range(EME_TIME_STEPS)]
    step = make_rx_step(rx.geo, rx.params, rx.blanker_pulsewidth,
                        fractional_tune=True)
    tune = (rx._tune_bin, rx._tune_frac, rx._tune_slope)

    def receiver():
        for b in blocks:
            rx.process_block(b)

    def bare():
        for b in blocks:
            rx.state, _ = step(rx.tables, rx.state, b, *tune)

    reads0 = rx.control.host_reads
    times = {"receiver": [], "bare step": []}
    for label in ("receiver", "bare step", "bare step", "receiver"):
        fn = receiver if label == "receiver" else bare
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(blocks)
        times[label].append(ms)
        print(f"eme timing {label}: {ms:.3f} ms/step (CUDA events), host "
              f"{1e3 * host_s / len(blocks):.3f} ms/step, "
              f"{s / ms / 1e3:.3f} complex Msamples/s per channel "
              f"[{dev['smi']}]")
    reads = (rx.control.host_reads - reads0) / (2 * len(blocks))
    cost = (sum(times["receiver"]) - sum(times["bare step"])) / 2
    print(f"eme timing: {reads:.0f} fft2_power host read per Receiver step; "
          f"Receiver minus bare step {cost:.3f} ms/step")
    if reads != 1:
        raise AssertionError("expected one host read per Receiver step")


def audio_peak_hz(audio: torch.Tensor, fs: float) -> float:
    """Frequency of the strongest line of a real audio stream (S,)."""
    a = audio.double().cpu().numpy()
    spec = np.abs(np.fft.rfft(a)) ** 2
    return (np.argmax(spec[1:]) + 1) * fs / a.size


def multi_params(fft1_variant: str, tiny: bool, spur: bool = True):
    """The flagship configuration with spur cancellation, squelch and
    expander; ``tiny`` cuts it to size for a rehearsal on the CPU."""
    from linrad_tpu_torch import flagship_params
    return dataclasses.replace(
        flagship_params(tiny=tiny, fft1_variant=fft1_variant),
        spur_enable=spur, squelch_enable=True, expander_exponent=2.0)


def multi_dials(geo, k_sub: int) -> list:
    """k_sub dial frequencies on fftx bin centres, spread unevenly over
    the band, none within 2.5 kHz of the strong carrier."""
    fs, n = geo.timf1_sampling_speed, geo.fftx_size
    cand = -0.45 * fs + 0.9 * fs * np.arange(k_sub + 4) / (k_sub + 3)
    cand = cand + np.random.default_rng(11).uniform(-0.005, 0.005,
                                                    cand.size) * fs
    cand = [f for f in cand if abs(f - CARRIER_HZ) > 2500.0
            and abs(f - MULTI_SPUR_HZ) > 2500.0][:k_sub]
    return [round(f / fs * n) * fs / n for f in cand]


def dial_protecting_manager(geo, dials):
    """A SpurManager that protects every dial's passband.

    The manager protects +-7 bins around one tuned bin (the Receiver's own,
    sub-receiver 0's for a MultiReceiver), and a tone that opens the
    squelch stands 25 dB over the median fft2 bin, 11 dB over the manager's
    threshold: it would take the other dials' signals for spurs.  This one
    sees the median level at +-7 bins around every dial, so it can only
    pick what lies between them: here the strong carrier, which sellim has
    limited to 26 dB over the median by the time fft2 sees it."""
    from linrad_tpu_torch.weak.spur import SpurManager
    n, fs = geo.fftx_size, geo.timf1_sampling_speed
    centres = np.array([int(round(f / fs * n)) for f in dials])
    protected = (centres[:, None] + np.arange(-7, 8)[None, :]).ravel() % n

    class DialProtectingManager(SpurManager):
        def scan(self, avg_power, state, protect_lo=-1, protect_hi=-1):
            avg = np.array(avg_power, np.float64)
            avg[protected] = np.median(avg)
            return super().scan(avg, state, protect_lo, protect_hi)

    return DialProtectingManager(geo)


def run_multi(p, k_sub: int, dials, iq: np.ndarray, steps: int, device,
              scan_interval: int | None = None):
    """MultiReceiver over ``steps`` steps with the spur manager scanning
    beside it.  ``device`` None takes the receiver's default;
    ``scan_interval`` overrides the control's (a rehearsal at a tiny step
    size, where the interval is far longer than the run).  Returns
    (receiver, control, outputs, spur slot bins after each step)."""
    from linrad_tpu_torch.pipeline.control import WeakSignalControl
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    rx = (MultiReceiver(p, k_sub) if device is None
          else MultiReceiver(p, k_sub, device=device))
    for k, f in enumerate(dials):
        rx.tune_subch(k, f)
    ctl = WeakSignalControl(rx.geo, p, rx.device)
    if ctl.spur_manager is not None:
        ctl.spur_manager = dial_protecting_manager(rx.geo, dials)
    if scan_interval:
        ctl.spur_scan_interval = scan_interval
    s = rx.geo.samples_per_step
    outs, slots = [], []
    for i in range(steps):
        out = rx.process_block(iq[i * s:(i + 1) * s])
        _bins, rx.state = ctl.update(out, rx._tune_bins, rx.state)
        outs.append(out)
        slots.append(None if rx.state.spur is None
                     else rx.state.spur.bins.cpu().numpy().copy())
    return rx, ctl, outs, slots


def count_device_ops(fn) -> tuple:
    """(aten operations, device kernels and copies) of one call of fn, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.key_averages()
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    cuda = sum(e.count for e in events
               if str(e.device_type).endswith("CUDA"))
    return aten, cuda


def phase_multi(dev: dict, device=None, tiny: bool = False,
                k_sub: int = MULTI_K, scan_interval: int | None = None
                ) -> int:
    """The multi-receiver path.  Returns the kernel's launch count over
    its MULTI_STEPS steps.  ``device="cpu"`` with ``tiny=True`` rehearses
    the control flow (the launch count is then not checked)."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver, Receiver
    on_card = device is None or torch.device(device).type == "cuda"
    p = multi_params("pallas", tiny)
    geo = derive_geometry(p)
    dials = multi_dials(geo, k_sub)
    steps = MULTI_STEPS
    iq = make_input(geo, seed=5, steps=steps + MULTI_TIME_STEPS, tones=dials,
                    tone_amplitude=MULTI_TONE_AMPLITUDE,
                    spur=(MULTI_SPUR_HZ, MULTI_SPUR_AMPLITUDE))
    fused_fft1.launches = 0
    rx, ctl, outs, slots = run_multi(p, k_sub, dials, iq, steps, device,
                                     scan_interval)
    launches = fused_fft1.launches
    interval = ctl.spur_scan_interval
    print(f"multi path: MultiReceiver K={k_sub} on {rx.device}, {steps} steps "
          f"of {geo.samples_per_step} samples, fused_fft1 launches "
          f"{launches}; spur scan every {interval} step(s); host reads "
          f"{ctl.host_reads} ({ctl.host_reads / steps:.1f} per step)")
    if on_card and launches != steps:
        raise AssertionError(f"multi: expected {steps} kernel launches (one "
                             f"per step), saw {launches}")
    if on_card and rx.device.type != "cuda":
        raise AssertionError("multi: the default device is not the card")
    shapes = flagship_shapes(geo, (k_sub,))
    check_outputs(outs, shapes)
    print(f"multi: blanker_fitted {[int(o.blanker_fitted) for o in outs]}; "
          f"blanker_cleared {[int(o.blanker_cleared) for o in outs]}")

    # the spurs: one slot on each carrier's bin; the steady weak one more
    # than 20 dB down
    n = geo.fftx_size
    fs = geo.timf1_sampling_speed
    carrier_bin = int(round(CARRIER_HZ / fs * n)) % n
    spur_bin = int(round(MULTI_SPUR_HZ / fs * n)) % n
    held = [int(b) for b in slots[-1] if b >= 0]
    print(f"multi: spur slots after each step "
          f"{[[int(b) for b in sl if b >= 0] for sl in slots]}; the strong "
          f"carrier at fft2 bin {carrier_bin}, the weak one at {spur_bin}")
    for b in (carrier_bin, spur_bin):
        # (at the tiny size the weak carrier stays under the manager's
        # threshold)
        if sum(abs(h - b) <= 1 for h in held) != 1 and not tiny:
            raise AssertionError(f"multi: no single spur slot on bin {b}: "
                                 f"{held}")
    _, _, plain, _ = run_multi(multi_params("pallas", tiny, spur=False),
                               k_sub, dials, iq, steps, device,
                               scan_interval)
    on = outs[-1].fft2_power[:, 0].double()
    off = plain[-1].fft2_power[:, 0].double()
    med = off.median().item()
    down = {b: 10 * np.log10(off[b].item() / on[b].item())
            for b in (carrier_bin, spur_bin)}
    dial_bins = [int(round(f / fs * n)) % n for f in dials]
    dial_db = (10 * torch.log10(on[dial_bins] / off[dial_bins])).abs().max()
    print(f"multi: fft2_power with spur cancellation against the same run "
          f"without: the weak carrier {down[spur_bin]:.1f} dB down (bar 20 "
          f"dB; it stood {10 * np.log10(off[spur_bin].item() / med):.1f} dB "
          f"over the median bin); the strong carrier, limited by sellim, "
          f"{down[carrier_bin]:.1f} dB down (bar 10 dB; it stood "
          f"{10 * np.log10(off[carrier_bin].item() / med):.1f} dB over the "
          f"median); the {k_sub} dial bins within {dial_db.item():.3f} dB "
          f"(bar 3 dB)")
    if not tiny and (down[spur_bin] <= 20.0 or down[carrier_bin] <= 10.0
                     or dial_db.item() >= 3.0):
        raise AssertionError("multi: a spur is not down by its bar, or a "
                             "dial bin moved by 3 dB")

    # every sub-receiver's audio: finite, non-zero, at the BFO pitch
    audio = torch.cat([o.audio for o in outs], dim=1)[:, :, 0]
    peaks = [audio_peak_hz(audio[k], geo.baseband_sampling_speed)
             for k in range(k_sub)]
    gates = rx.nbs.squelch.gate.cpu().numpy()
    print(f"multi: audio peaks (Hz) {[round(float(f), 1) for f in peaks]}; squelch "
          f"gates {np.round(gates, 3).tolist()}")
    if not tiny:
        for k, f in enumerate(peaks):
            if float(audio[k].abs().max()) == 0 or abs(f - BFO_HZ) > 20.0:
                raise AssertionError(f"multi: sub-receiver {k} has no tone "
                                     f"at the BFO pitch: peak {f} Hz")

    # three sub-receivers against a single Receiver on the same dial
    s = geo.samples_per_step
    for k in sorted({0, k_sub // 2, k_sub - 1}):
        one = Receiver(p, device=rx.device)
        one.control.spur_manager = dial_protecting_manager(geo, dials)
        if scan_interval:
            one.control.spur_scan_interval = scan_interval
        one.tune(dials[k])
        worst = 0.0
        for i in range(steps):
            ref = one.process_block(iq[i * s:(i + 1) * s])
            worst = max(worst, max_rel(outs[i].baseb[k], ref.baseb))
        print(f"multi: sub-receiver {k} (dial {dials[k]:.1f} Hz) vs a "
              f"single Receiver: baseb max_rel {worst:.3e} (bar 1e-4)")
        # (at the tiny size the impulses make every fft1 bin strong, and
        # the front end then depends on which dial's passband it protects)
        if worst > 1e-4 and not tiny:
            raise AssertionError(f"multi: sub-receiver {k} differs from the "
                                 f"single Receiver")

    # the kernel against torch.fft
    _, _, ref, ref_slots = run_multi(multi_params("xla", tiny), k_sub, dials,
                                     iq, steps, device, scan_interval)
    for i, (a, b) in enumerate(zip(slots, ref_slots)):
        if not np.array_equal(a, b):
            raise AssertionError(f"multi step {i}: spur slot bins differ "
                                 f"from the xla receiver's: {a} != {b}")
    print("multi: pallas vs xla spur slot bins exact in every step")
    compare_runs(outs, ref, shapes, "multi: ", MULTI_START_TOL)

    if on_card:
        phase_multi_timing(dev, p, dials, iq[steps * s:])
    return launches


def phase_multi_timing(dev: dict, p, dials, iq: np.ndarray) -> None:
    """Step time at K = 1 and K = MULTI_K in turns, the device operations
    per step at both, and the no-synchronisation check."""
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    times, ops = {}, {}
    for k_sub in (1, MULTI_K, MULTI_K, 1):
        rx = MultiReceiver(p, k_sub)
        for k in range(k_sub):
            rx.tune_subch(k, dials[k])
        s = rx.geo.samples_per_step
        blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
                  for i in range(iq.shape[0] // s)]
        for b in blocks[:2]:
            rx.process_block(b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for b in blocks:
            rx.process_block(b)
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(blocks)
        times.setdefault(k_sub, []).append(ms)
        print(f"multi timing K={k_sub}: {ms:.3f} ms/step (CUDA events), "
              f"host enqueue {1e3 * host_s / len(blocks):.3f} ms/step, "
              f"{s / ms / 1e3:.3f} complex Msamples/s in, "
              f"{k_sub * s / ms / 1e3:.3f} summed over sub-receivers "
              f"[{dev['smi']}]")
        if k_sub not in ops:
            ops[k_sub] = count_device_ops(
                lambda: rx.process_block(blocks[0]))
            torch.cuda.set_sync_debug_mode("error")
            try:
                rx.process_block(blocks[0])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    for k_sub, (aten, cuda) in ops.items():
        print(f"multi: operations per step at K={k_sub}: {aten} aten "
              f"operations, {cuda} device kernels and copies "
              f"(torch.profiler)")
    ratio = (sum(times[MULTI_K]) / sum(times[1]))
    print(f"multi timing: K={MULTI_K} step / K=1 step = {ratio:.3f}; a "
          f"multi-receiver step on device input makes no host "
          f"synchronisation")
    a1, a24 = ops[1][0], ops[MULTI_K][0]
    if abs(a24 - a1) > 0.01 * a1:
        raise AssertionError(f"multi: operations per step grow with K: "
                             f"{a1} at K=1, {a24} at K={MULTI_K}")


def phase_real(dev: dict, device="cuda", tiny: bool = False) -> int:
    """Real input, mixer mode 2 and the audio resampler, then I/Q
    correction on IQ input.  Returns the kernel's launch count on these
    paths, which must be 0 (the uncorrected receiver that the corrected one
    is compared with does launch it; that is not counted)."""
    from linrad_tpu_torch import InputMode, derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import Receiver
    base = flagship_params(tiny=tiny, fft1_variant="pallas")
    p = dataclasses.replace(base, rx_ad_speed=2 * base.rx_ad_speed,
                            input_mode=InputMode.REAL, mixer_mode=2)
    geo = derive_geometry(p)
    fs_out = 2.0 * geo.baseband_sampling_speed
    print(f"real path: A/D {geo.rx_ad_speed} Hz real, timf1 "
          f"{geo.timf1_sampling_speed:.0f} Hz, fft1 {geo.fft1_size} "
          f"({geo.fft1_frames_per_step} frames of {2 * geo.fft1_size} real "
          f"samples), fft2 {geo.fft2_size}, mixer mode 2, baseband "
          f"{geo.baseband_sampling_speed:.0f} Hz resampled to {fs_out:.0f} Hz")
    fused_fft1.launches = 0
    rx = Receiver(p, device=device, audio_out_rate=fs_out)
    dial = round(TUNE_HZ / geo.timf1_sampling_speed * geo.fftx_size) \
        * geo.timf1_sampling_speed / geo.fftx_size
    rx.tune(dial)
    rng = np.random.default_rng(9)
    rows = 2 * geo.samples_per_step
    n = REAL_STEPS * rows
    t = np.arange(n) / geo.rx_ad_speed
    x = (8.0 * np.cos(2 * np.pi * dial * t) + 10.0 * rng.normal(size=n)
         + 2000.0 * np.cos(2 * np.pi * 30_000.0 * t + 0.3)
         ).astype(np.float32)[:, None]
    blocks = [torch.from_numpy(x[i * rows:(i + 1) * rows]).to(device)
              for i in range(REAL_STEPS)]
    outs = [rx.process_block(b) for b in blocks]
    fir = rx.tables.mix2.fir.shape[0]
    block_out = rx._resampler.block_out
    print(f"real: {len(outs)} steps of {rows} real samples, FIR of {fir} "
          f"taps, audio {tuple(outs[-1].audio.shape)} per step (block_out "
          f"{block_out}), fused_fft1 launches {fused_fft1.launches}")
    bb = geo.baseband_samples_per_step
    shapes = {"audio": (block_out, 1), "baseb": (bb, 1),
              "fft1_power": (geo.fft1_size, 1), "agc_gain": (bb, 1),
              "fft2_power": (geo.fft2_size, 1), "liminfo": (geo.fft1_size,)}
    check_outputs(outs, shapes)
    if block_out != 2 * bb:
        raise AssertionError("real: the resampler does not double the rate")
    audio = torch.cat([o.audio for o in outs[1:]])[:, 0]
    peak = audio_peak_hz(audio, fs_out)
    print(f"real: audio spectrum peak at {peak:.1f} Hz at the resampled "
          f"rate (BFO {BFO_HZ} Hz)")
    if not tiny and abs(peak - BFO_HZ) > 20.0:
        raise AssertionError("real: the tone is not at the BFO pitch")
    if torch.device(device).type == "cuda":
        for b in blocks[:2]:
            rx.process_block(b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in blocks:
            rx.process_block(b)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / len(blocks)
        print(f"real timing: {ms:.3f} ms/step (CUDA events), "
              f"{rows / ms / 1e3:.3f} real Msamples/s [{dev['smi']}]")
    real_launches = fused_fft1.launches

    # I/Q image correction on IQ input: the unfused path as well
    geo_iq = derive_geometry(base)
    corr = 0.01 * (rng.normal(size=geo_iq.fft1_size)
                   + 1j * rng.normal(size=geo_iq.fft1_size))
    iq = make_input(geo_iq, seed=6, steps=3)
    s = geo_iq.samples_per_step
    powers = []
    for cal in ({"iq_corr": corr.astype(np.complex64)}, None):
        rx = Receiver(base, device=device, calibration=cal)
        rx.tune(TUNE_HZ)
        before = fused_fft1.launches
        outs = [rx.process_block(iq[i * s:(i + 1) * s]) for i in range(3)]
        check_outputs(outs, {"audio": (geo_iq.baseband_samples_per_step, 1),
                             "fft1_power": (geo_iq.fft1_size, 1)})
        if cal is not None:
            corr_launches = fused_fft1.launches - before
        powers.append(outs[-1].fft1_power)
    image_bin = (-int(round(CARRIER_HZ / geo_iq.timf1_sampling_speed
                            * geo_iq.fft1_size))) % geo_iq.fft1_size
    print(f"real: iq_corr on IQ input, 3 steps, fused_fft1 launches "
          f"{corr_launches}; fft1_power at the carrier's image bin "
          f"{image_bin}: {powers[0][image_bin].item():.4g} with the table, "
          f"{powers[1][image_bin].item():.4g} without")
    if corr_launches != 0 or real_launches != 0:
        raise AssertionError("real: the kernel was launched on a path the "
                             "JAX package's dispatch sends to the plain FFT")
    if torch.equal(powers[0], powers[1]):
        raise AssertionError("real: the I/Q correction changed nothing")
    return real_launches + corr_launches


# ---- the host layer: phases 10 to 14 -----------------------------------

def eager_batch(p, tune_hz: float, iq: np.ndarray, device) -> dict:
    """What BatchRunner computes, by the bare step run eagerly in a loop:
    the same tables, state and tuning, no fractional ramp, one block at a
    time copied to the device, audio and baseb brought back at the end."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline.chain import (RxState, RxTables,
                                                 make_rx_step)
    from linrad_tpu_torch.pipeline.receiver import _pulsewidth
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p, device)
    state = RxState.create(geo, device)
    step = make_rx_step(geo, p, blanker_pulsewidth=_pulsewidth(geo))
    n = geo.fftx_size
    tune = torch.tensor(int(round(tune_hz / geo.timf1_sampling_speed * n))
                        % n, dtype=torch.int64, device=device)
    s = geo.samples_per_step
    audio, baseb = [], []
    for i in range(iq.shape[0] // s):
        block = torch.from_numpy(iq[i * s:(i + 1) * s]).to(device)
        state, out = step(tables, state, block, tune)
        audio.append(out.audio)
        baseb.append(out.baseb)
    return {"audio": torch.cat(audio).cpu().numpy(),
            "baseb": torch.cat(baseb).cpu().numpy()}


def timed_ms(fn) -> float:
    """Milliseconds between CUDA events around one call of fn."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profile_call(fn) -> dict:
    """One call of fn under torch.profiler.  "busy_ms": the device's busy
    time summed over every kernel and copy traced; "wall_ms": the time
    between CUDA events around the call, under the profiler; "ops": the
    device kernels and copies; "by_name": (name, ms, count) of each, most
    device time first; "host": what the call asks of the CUDA runtime, by
    name (graph launches, kernel launches, copies), and under "aten" its
    aten operations."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    busy_us, ops, by_name, host = 0.0, 0, [], {"aten": 0}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            busy_us += us
            ops += e.count
            by_name.append((e.key, round(us / 1e3, 3), e.count))
        elif e.key.startswith("aten::"):
            host["aten"] += e.count
        elif e.key.startswith(("cudaGraphLaunch", "cudaLaunchKernel",
                               "cudaMemcpy", "cuLaunchKernel")):
            host[e.key] = host.get(e.key, 0) + e.count
    by_name.sort(key=lambda kv: -kv[1])
    return {"busy_ms": busy_us / 1e3, "wall_ms": start.elapsed_time(end),
            "ops": ops, "by_name": by_name, "host": host}


def graph_pool_bytes(graph) -> int:
    """Bytes of the allocator's segments that belong to the private memory
    pool of a captured torch.cuda.CUDAGraph."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == pool)


def phase_batch(dev: dict, device=None, tiny: bool = False) -> int:
    """K steps per call from a CUDA graph.  Returns the kernel's launch
    count over the runner's BATCH_STEPS steps, as the runner counts it
    (launches per replay times replays).  ``device="cpu"`` with
    ``tiny=True`` rehearses the control flow."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.batch import BatchRunner
    on_card = device is None or torch.device(device).type == "cuda"
    kw = {} if device is None else {"device": device}
    p = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = make_input(geo, seed=2, steps=BATCH_STEPS)
    s = geo.samples_per_step

    def runner(params=p):
        br = BatchRunner(params, k_steps=BATCH_K, **kw)
        br.tune(TUNE_HZ)
        return br

    br = runner()
    fused_fft1.launches = 0
    got = br.process(iq)
    g = br.graphed
    pool = graph_pool_bytes(g.graph) if on_card else 0
    print(f"batch path: BatchRunner k_steps={BATCH_K} on {br.device}, "
          f"{BATCH_STEPS} steps of {s} samples in {BATCH_STEPS // BATCH_K} "
          f"calls; {g.replays} replays of one captured step, "
          f"{br.kernels_per_replay} fused_fft1 node(s) recorded in it, "
          f"launches {br.kernel_launches} (the wrapper was called "
          f"{fused_fft1.launches} times); capture {g.capture_seconds:.3f} s, "
          f"graph pool {pool} bytes [{dev['smi']}]")
    if on_card and (br.device.type != "cuda" or g.graph is None):
        raise AssertionError("batch: the default device is not the card, or "
                             "the step was not captured")
    if on_card and (br.kernel_launches != BATCH_STEPS
                    or fused_fft1.launches != 0 or pool <= 0):
        raise AssertionError(f"batch: expected {BATCH_STEPS} kernel "
                             f"launches, all from replays, and a graph pool")
    bb = geo.baseband_samples_per_step
    for f, dtype in (("audio", np.float32), ("baseb", np.complex64)):
        if got[f].shape != (BATCH_STEPS * bb, 1) or got[f].dtype != dtype \
                or not np.isfinite(got[f]).all():
            raise AssertionError(f"batch: {f} has the wrong shape or type, "
                                 f"or is not finite")
    peak = audio_peak_hz(torch.from_numpy(got["audio"][:, 0]),
                         geo.baseband_sampling_speed)
    print(f"batch: audio spectrum peak at {peak:.1f} Hz (BFO {BFO_HZ} Hz)")
    if not tiny and abs(peak - BFO_HZ) > 20.0:
        raise AssertionError("batch: the tone is not at the BFO pitch")

    ref = eager_batch(p, TUNE_HZ, iq, br.device)
    again = runner().process(iq)
    for label, other in (("the eager loop of the same step", ref),
                         ("a fresh runner", again)):
        for f in ("audio", "baseb"):
            if not np.array_equal(got[f], other[f]):
                diff = np.abs(got[f] - other[f]).max()
                raise AssertionError(f"batch: {f} differs from {label} "
                                     f"(max abs {diff})")
        print(f"batch: audio and baseb bit-equal to {label}")

    xla = runner(flagship_params(tiny=tiny, fft1_variant="xla")).process(iq)
    for f, bar in (("audio", CHAIN_TOL["audio"]), ("baseb", CHAIN_TOL_OTHER)):
        first = max_rel(torch.from_numpy(got[f][:bb]),
                        torch.from_numpy(xla[f][:bb]))
        rest = max_rel(torch.from_numpy(got[f][bb:]),
                       torch.from_numpy(xla[f][bb:]))
        bar0 = START_AUDIO_TOL if f == "audio" else bar
        print(f"batch: pallas vs xla runner, {f}: step 0 max_rel "
              f"{first:.3e} (bar {bar0}), steps 1-{BATCH_STEPS - 1} "
              f"{rest:.3e} (bar {bar})")
        if tiny:
            continue    # the bars are the full size's
        if first > bar0 or rest > bar:
            raise AssertionError(f"batch: {f} of the xla runner is outside "
                                 f"its bar")
    launches = br.kernel_launches
    if on_card:
        phase_batch_timing(dev, p, iq, br)
    return launches


def phase_batch_timing(dev: dict, p, iq: np.ndarray, br) -> None:
    """One call under torch.profiler (what the host enqueues, what the
    device runs); the graphed and the eager step in turns, whole calls
    between CUDA events; the replays alone."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    s = br.geo.samples_per_step
    steps = iq.shape[0] // s
    counted = fused_fft1.launches

    # a call's K steps make no host synchronisation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        br._run_call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    fns = {"eager": lambda: eager_batch(p, TUNE_HZ, iq, br.device),
           "graph": lambda: br.process(iq)}
    for fn in fns.values():                     # warm-up of both paths
        fn()
    times = {}
    for label in ("eager", "graph", "graph", "eager"):
        t0 = time.perf_counter()
        ms = timed_ms(fns[label]) / steps
        host = 1e3 * (time.perf_counter() - t0) / steps
        times.setdefault(label, []).append(ms)
        print(f"batch timing {label}: {ms:.3f} ms/step (CUDA events around "
              f"{steps} steps, the copies in and out included), host "
              f"{host:.3f} ms/step, {s / ms / 1e3:.3f} complex Msamples/s "
              f"[{dev['smi']}]")
    ratio = sum(times["eager"]) / sum(times["graph"])
    print(f"batch timing: eager / graph = {ratio:.2f}")

    def replays(when: str) -> float:
        ms = [timed_ms(br._run_call) for _ in range(3)]
        print(f"batch timing graph, the replays alone, {when}: "
              f"{min(ms) / BATCH_K:.3f} ms/step (best of 3 calls of "
              f"{BATCH_K} steps; all {[round(m / BATCH_K, 3) for m in ms]}),"
              f" {s * BATCH_K / min(ms) / 1e3:.3f} complex Msamples/s "
              f"[{dev['smi']}]")
        return min(ms)

    replays("before the profiler's pass")
    prof = profile_call(br._run_call)
    replay_ms = replays("after it")
    host = prof["host"]
    enqueued = sum(n for k, n in host.items() if k != "aten")
    print(f"batch: the {BATCH_K} steps of a call make no host "
          f"synchronisation; the host enqueues {enqueued} operations "
          f"({host}; aten operations, views included: "
          f"{host['aten'] / BATCH_K:.1f} per step; the eager step makes "
          f"thousands)")
    if enqueued > 4 * BATCH_K or host.get("cudaGraphLaunch") != BATCH_K:
        raise AssertionError("batch: a call enqueues more than a small "
                             "multiple of K operations")
    kernels = sum(n for name, _, n in prof["by_name"]
                  if "fused_fft1_kernel" in name)
    print(f"batch profile: the device ran fused_fft1_kernel {kernels} times "
          f"in a call of {BATCH_K} replays; the runner counts "
          f"{br.kernels_per_replay} per replay")
    # torch.profiler has been seen to drop a few of a call's 60,000-odd
    # events (phase 18): fewer than K runs are printed, more would fail
    if br.kernels_per_replay != 1 or not 1 <= kernels <= BATCH_K:
        raise AssertionError("batch: the device ran the kernel more than "
                             "once per replay, or never")
    busy, wall = prof["busy_ms"], prof["wall_ms"]
    # the device's time is taken under the profiler and the replays' wall
    # time without it, in the calls just after: their ratio is printed as
    # it comes out, and may pass 1
    print(f"batch profile graph: one call of {BATCH_K} steps: device time "
          f"{busy / BATCH_K:.3f} ms/step in {prof['ops'] // BATCH_K} kernels "
          f"and copies per step; wall under the profiler "
          f"{wall / BATCH_K:.3f} ms/step (device time / wall "
          f"{busy / wall:.4f}), without it {replay_ms / BATCH_K:.3f} ms/step "
          f"(device time / wall {busy / replay_ms:.4f}) (torch.profiler) "
          f"[{dev['smi']}]")
    if busy <= 0:
        raise AssertionError("batch: torch.profiler saw no device time")
    for name, ms, n in prof["by_name"][:5]:
        print(f"batch profile graph:   {ms / BATCH_K:.3f} ms/step in "
              f"{n // BATCH_K} launches per step: {name[:120]}")
    # the launches made for timing are not the main path's
    fused_fft1.launches = counted


def replay_regimes(dev: dict) -> None:
    """A diagnostic: the graphed flagship step's time at points of one
    process's life.  The same graph on the same data has been seen to
    replay at two speeds about 20% apart, and to change between them after
    another capture, after a pass of torch.profiler, and after an eager
    loop; not after memory taken with cudaMalloc or freed with cudaFree.
    Prints ms per step of whole process() calls of BATCH_STEPS steps at
    each point, and the card's clocks."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.pipeline.batch import BatchRunner
    p = flagship_params(fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = make_input(geo, seed=2, steps=BATCH_STEPS)

    def runner():
        br = BatchRunner(p, k_steps=BATCH_K)
        br.tune(TUNE_HZ)
        return br

    def loop(br, label: str, n: int = 8) -> None:
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            br.process(iq)
            ms.append(round(1e3 * (time.perf_counter() - t0) / BATCH_STEPS,
                            2))
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,pstate,"
             "clocks_throttle_reasons.active,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"regimes, {label}: ms/step of {n} process() calls {ms} "
              f"({clocks}) [{dev['smi']}]", flush=True)

    first = runner()
    loop(first, "a fresh runner, no profiler started yet", 16)
    big = torch.empty(1 << 28, dtype=torch.uint8, device=first.device)
    loop(first, "after a new cudaMalloc of 256 MiB")
    del big
    torch.cuda.empty_cache()
    loop(first, "after its cudaFree")
    profile_call(first._run_call)
    loop(first, "after torch.profiler's first pass")
    second = runner()
    loop(second, "a second runner, just captured")
    loop(first, "the first runner after that capture")
    profile_call(first._run_call)
    loop(first, "after another pass of the profiler")
    eager_batch(p, TUNE_HZ, iq, first.device)
    loop(first, "after an eager loop of 16 steps", 16)


def equal_outputs(a, b, label: str) -> None:
    """Every tensor field of two RxOutputs equal bit for bit."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if (va is None) != (vb is None) or (
                va is not None and not torch.equal(va, vb)):
            raise AssertionError(f"{label}: {f.name} differs")


def phase_checkpoint(dev: dict, device="cuda", tiny: bool = False,
                     **eme_overrides) -> int:
    """Save and resume, on the flagship and across the AFC's lock on the
    EME configuration.  Returns the kernel's launch count."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.checkpoint import (load_receiver,
                                                      save_receiver)
    from linrad_tpu_torch.pipeline.receiver import Receiver
    fused_fft1.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        p = flagship_params(tiny=tiny, fft1_variant="pallas")
        rx = Receiver(p, device=device)
        rx.tune(TUNE_HZ)
        s = rx.geo.samples_per_step
        iq = make_input(rx.geo, seed=4, steps=8)
        straight = list(rx.run(iq))
        rx1 = Receiver(p, device=device)
        rx1.tune(TUNE_HZ)
        for _ in rx1.run(iq[:4 * s]):
            pass
        path = os.path.join(tmp, "flagship.npz")
        save_receiver(path, rx1)
        rx2 = load_receiver(path, device=device)
        for i, out in enumerate(rx2.run(iq[4 * s:])):
            equal_outputs(out, straight[4 + i], f"checkpoint step {5 + i}")
        print(f"checkpoint: flagship, saved after 4 steps "
              f"({os.path.getsize(path)} bytes), resumed on {rx2.device}: "
              f"every output field of steps 5-8 bit-equal to the "
              f"uninterrupted run")

        pe = eme_params("pallas", **eme_overrides)
        iq = make_eme_input(derive_geometry(pe), EME_STEPS)
        rx = Receiver(pe, device=device)
        rx.tune(EME_TUNE_HZ)
        s = rx.geo.samples_per_step
        straight, track, saved_at, rx2 = [], [], None, None
        resumed = []
        for i in range(EME_STEPS):
            block = iq[i * s:(i + 1) * s]
            straight.append(rx.process_block(block))
            track.append(rx.afc.status)
            if rx2 is not None:
                out = rx2.process_block(block)
                equal_outputs(out, straight[-1], f"checkpoint eme step {i}")
                if (rx2.afc.status != rx.afc.status
                        or rx2.afc.freq_hz != rx.afc.freq_hz
                        or not torch.equal(rx2._tune_bin, rx._tune_bin)
                        or not torch.equal(rx2._tune_frac, rx._tune_frac)
                        or not torch.equal(rx2._tune_slope, rx._tune_slope)):
                    raise AssertionError(f"checkpoint eme step {i}: the AFC "
                                         f"or the tuning went another way")
                resumed.append(rx2.afc.status)
            elif rx.afc.status in (2, 3) and i < EME_STEPS - 3:
                path = os.path.join(tmp, "eme.npz")
                save_receiver(path, rx)
                rx2 = load_receiver(path, device=device)
                saved_at = i
        if rx2 is None or len(resumed) < 3 or 3 not in track:
            raise AssertionError(f"checkpoint: the AFC did not lock in time "
                                 f"to resume: {track}")
        print(f"checkpoint: eme, AFC status per step {track}, saved after "
              f"step {saved_at} (status {track[saved_at]}), resumed over "
              f"steps {saved_at + 1}-{EME_STEPS - 1} (status {resumed}): "
              f"outputs, AFC status and frequency, frame bins, tune_frac "
              f"and tune_slope equal in every step")
    return fused_fft1.launches


def phase_file(dev: dict, device="cuda", tiny: bool = False) -> int:
    """WAV replay through the native prefetcher.  Returns the kernel's
    launch count over the replay's FILE_STEPS steps."""
    from linrad_tpu_torch import derive_geometry, flagship_params, runtime
    from linrad_tpu_torch.io.wav import RcvrChunk, write_wav
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import Receiver
    if runtime.get_lib() is None:
        raise AssertionError("file: the native runtime library did not "
                             "build or load (g++)")
    print(f"file: native runtime {runtime._lib_path()}")
    p = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = make_input(geo, seed=7, steps=FILE_STEPS)[:, 0]
    iq = (np.round(iq.real) + 1j * np.round(iq.imag)).astype(np.complex64)
    if np.abs(iq.real).max() > 32767 or np.abs(iq.imag).max() > 32767:
        raise AssertionError("file: the input does not fit 16 bits")
    rx_mem = Receiver(p, device=device)
    rx_mem.tune(TUNE_HZ)
    mem = torch.cat([o.audio for o in rx_mem.run(iq)])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.wav")
        write_wav(path, iq[:, None], geo.rx_ad_speed, bits=16,
                  rcvr=RcvrChunk(center_frequency_hz=14_100_000))
        size = os.path.getsize(path)
        rx = Receiver(p, device=device)
        rx.tune(TUNE_HZ)
        fused_fft1.launches = 0
        t0 = time.perf_counter()
        outs = list(rx.run_file(path))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fused_fft1.launches
    audio = torch.cat([o.audio for o in outs])
    print(f"file: {len(outs)} steps replayed from a {size}-byte 16-bit IQ "
          f"WAV in {seconds:.3f} s, fused_fft1 launches {launches}, "
          f"center_frequency_hz {rx.center_frequency_hz}")
    if len(outs) != FILE_STEPS or rx.center_frequency_hz != 14_100_000.0:
        raise AssertionError("file: steps or centre frequency")
    if torch.device(device).type == "cuda" and launches != FILE_STEPS:
        raise AssertionError(f"file: expected {FILE_STEPS} kernel launches")
    if not torch.equal(audio, mem) or not torch.isfinite(audio).all():
        raise AssertionError("file: the audio differs from run() on the "
                             "same samples")
    rx.tune_rf(14_100_000.0 + TUNE_HZ)
    if abs(rx.tuned_hz - TUNE_HZ) > 1e-3:
        raise AssertionError("file: dial tuning by the centre frequency")
    print("file: audio bit-equal to run() on the 16-bit-rounded samples; "
          "tune_rf by the rcvr chunk's centre lands on the dial")
    return launches


def phase_latency(dev: dict, device="cuda", steps: int = 100) -> None:
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline.latency import (latency_params,
                                                   measure_latency,
                                                   pipeline_delay_samples)
    for second_fft in (False, True):
        p = latency_params(second_fft=second_fft)
        geo = derive_geometry(p)
        rep = measure_latency(p, steps=steps, device=device)
        print(f"latency second_fft={second_fft}: {json.dumps(rep)} "
              f"[{dev['smi']}]")
        want = ["block_ms", "proc_ms_p50", "proc_ms_p95", "pipeline_ms",
                "total_ms", "budget_ms", "within_budget", "sustained"]
        analytic = round(1e3 * pipeline_delay_samples(geo)
                         / geo.timf1_sampling_speed, 2)
        if list(rep) != want or rep["pipeline_ms"] != analytic \
                or not rep["proc_ms_p50"] > 0:
            raise AssertionError(f"latency: the report's fields, or "
                                 f"pipeline_ms != {analytic}")


def phase_radar_wfm(dev: dict, device="cuda") -> None:
    """frame_pulse_stats, the tracker and the stereo decoder on the device
    against the same functions on the CPU."""
    from linrad_tpu_torch.ops.demod import (wfm_stereo_decode,
                                            wfm_stereo_encode)
    from linrad_tpu_torch.weak.radar import (RadarParams, RadarTracker,
                                             frame_pulse_stats)
    # a pulse train on bin 100 every 40 frames, 3 frames wide, with skirts;
    # an echo 8 frames later, 26 dB down; the receiver muted while sending
    rng = np.random.default_rng(12)
    n_bins, frames = 2048, 1280
    bins = np.arange(n_bins)
    pw = rng.exponential(size=(frames, n_bins)).astype(np.float32) * 1e-3
    skirt = np.exp(-0.5 * ((bins - 100) / 2.0) ** 2)
    for f0 in range(5, frames, 40):
        pw[f0:f0 + 3] = pw[f0:f0 + 3] * 0.01 + 1e4 * skirt
        if f0 + 11 <= frames:
            pw[f0 + 8:f0 + 11] += 25.0 * skirt
    on_dev = frame_pulse_stats(torch.from_numpy(pw).to(device))
    on_cpu = frame_pulse_stats(torch.from_numpy(pw))
    if not torch.equal(on_dev[0].cpu(), on_cpu[0]):
        raise AssertionError("radar: peak bins differ from the CPU's")
    rel = [max_rel(a.cpu(), b) for a, b in zip(on_dev[1:], on_cpu[1:])]
    print(f"radar: frame_pulse_stats on {device} over {frames} frames of "
          f"{n_bins} bins against the CPU: peak bins exact, ston max_rel "
          f"{rel[0]:.3e}, noise floor max_rel {rel[1]:.3e} (bar 1e-5)")
    if max(rel) > 1e-5:
        raise AssertionError("radar: ston or noise floor outside 1e-5")
    trackers = [RadarTracker(n_bins=n_bins, frame_time_s=0.01, bin_hz=46.875,
                             params=RadarParams(lock_after=500), device=d)
                for d in (device, "cpu")]
    for i in range(0, frames, 64):
        for t in trackers:
            t.feed(pw[i:i + 64])
    a, b = trackers
    state = [(t.locked, t.pulse_sep, t.pulse_bin, t.lines, t.first_bin,
              t.last_bin, t.update_cnt, t.echo_peak()) for t in trackers]
    print(f"radar: tracker on {device}: locked {a.locked}, pulse_sep "
          f"{a.pulse_sep}, pulse_bin {a.pulse_bin}, {a.update_cnt} display "
          f"updates, echo (line, bin offset, doppler Hz) {a.echo_peak()}; "
          f"display max_rel against the CPU tracker "
          f"{max_rel(torch.from_numpy(a.average), torch.from_numpy(b.average)):.3e}")
    if state[0] != state[1] or not a.locked or a.pulse_sep != 40 \
            or a.pulse_bin != 100 or abs(a.echo_peak()[0] - 8) > 1:
        raise AssertionError(f"radar: the tracker's decisions: {state}")
    if max_rel(torch.from_numpy(a.average),
               torch.from_numpy(b.average)) > 1e-5:
        raise AssertionError("radar: the display differs from the CPU's")

    fs = 192_000.0
    t = np.arange(int(0.25 * fs)) / fs
    left = np.sin(2 * np.pi * 700.0 * t)
    right = np.sin(2 * np.pi * 2500.0 * t)
    comp = wfm_stereo_encode(left, right, fs)
    l, r, pil = wfm_stereo_decode(torch.from_numpy(comp).to(device), fs)
    lc, rc, pc = wfm_stereo_decode(torch.from_numpy(comp), fs)
    rel = max(max_rel(l.cpu(), lc), max_rel(r.cpu(), rc))
    l, r = l.double().cpu().numpy(), r.double().cpu().numpy()

    def tone_pwr(x, f):
        return abs(np.vdot(np.exp(2j * np.pi * f * t), x) / len(x)) ** 2

    sep_l = 10 * np.log10(tone_pwr(l, 700.0) / tone_pwr(l, 2500.0))
    sep_r = 10 * np.log10(tone_pwr(r, 2500.0) / tone_pwr(r, 700.0))
    print(f"wfm: wfm_stereo_decode on {device} over {len(t)} samples "
          f"against the CPU: max_rel {rel:.3e} (bar 1e-5); separation left "
          f"{sep_l:.1f} dB, right {sep_r:.1f} dB (bar 25 dB); pilot power "
          f"ratio {float(pil):.5f} (CPU {float(pc):.5f}, bar 1e-3)")
    if rel > 1e-5 or min(sep_l, sep_r) <= 25.0 or float(pil) <= 1e-3:
        raise AssertionError("wfm: the decode differs from the CPU's, or "
                             "the channels are not separated")


# ---- device code ported in the later slice: phases 15 to 18 ------------

def outputs_on(outs: list, device) -> list:
    """RxOutputs with every tensor moved to ``device``."""
    return [dataclasses.replace(o, **{
        f.name: getattr(o, f.name).to(device)
        for f in dataclasses.fields(o) if getattr(o, f.name) is not None})
        for o in outs]


def phase_rounds(dev: dict, device="cuda", tiny: bool = False) -> int:
    """blanker_rounds=8 through Receiver and BatchRunner.  Returns the
    kernel's launches over the two runs (8 + 16), each counted from
    zero."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.batch import BatchRunner
    on_card = torch.device(device).type == "cuda"
    base = flagship_params(tiny=tiny, fft1_variant="pallas")
    p = dataclasses.replace(base, blanker_rounds=ROUNDS)
    geo = derive_geometry(p)
    iq = make_input(geo)
    fused_fft1.launches = 0
    outs = run_rx(p, iq, device)
    rx_launches = fused_fft1.launches
    shapes = flagship_shapes(geo)
    check_outputs(outs, shapes)
    seq = run_rx(base, iq, device)
    fits = [int(o.blanker_fitted) for o in outs]
    seq_fits = [int(o.blanker_fitted) for o in seq]
    print(f"rounds: blanker_rounds={ROUNDS}, Receiver {len(outs)} steps, "
          f"fused_fft1 launches {rx_launches}; fits per step {fits} "
          f"(sequential blanker, up to {p.max_pulses_per_block}: "
          f"{seq_fits}); cleared "
          f"{[int(o.blanker_cleared) for o in outs]} "
          f"(sequential {[int(o.blanker_cleared) for o in seq]})")
    if on_card and rx_launches != STEPS:
        raise AssertionError(f"rounds: expected {STEPS} kernel launches")
    # (at the tiny size phase 4's impulses stay under the fit threshold)
    if max(fits) == 0 and not tiny:
        raise AssertionError("rounds: the blanker fitted nothing")
    compare_runs(outs, run_rx(dataclasses.replace(p, fft1_variant="xla"),
                              iq, device), shapes, "rounds: ")

    iq16 = make_input(geo, seed=2, steps=BATCH_STEPS)
    br = BatchRunner(p, k_steps=BATCH_K, device=device)
    br.tune(TUNE_HZ)
    fused_fft1.launches = 0
    got = br.process(iq16)
    batch_launches = br.kernel_launches
    wrapper = fused_fft1.launches
    print(f"rounds: BatchRunner k_steps={BATCH_K}, {BATCH_STEPS} steps, "
          f"{br.kernels_per_replay} fused_fft1 node(s) per replay, launches "
          f"{batch_launches} (wrapper calls {wrapper}); capture "
          f"{br.graphed.capture_seconds:.3f} s")
    if on_card and (batch_launches != BATCH_STEPS or wrapper != 0):
        raise AssertionError(f"rounds: expected {BATCH_STEPS} launches, all "
                             f"from replays")
    ref = eager_batch(p, TUNE_HZ, iq16, br.device)
    for f in ("audio", "baseb"):
        if not np.array_equal(got[f], ref[f]):
            raise AssertionError(f"rounds: {f} of the graph differs from "
                                 f"the eager loop")
    print("rounds: audio and baseb from the graph bit-equal to the eager "
          "loop of the same step")
    if on_card:
        phase_rounds_timing(dev, base, p, iq16)
    return rx_launches + batch_launches


def phase_rounds_timing(dev: dict, base, p, iq: np.ndarray) -> None:
    """The graphed step at blanker_rounds 0 and ROUNDS: device kernels per
    step from one profiled call each, then the replays alone in turns."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.batch import BatchRunner
    counted = fused_fft1.launches
    runners = {}
    for label, params in (("rounds=0", base), (f"rounds={ROUNDS}", p)):
        br = BatchRunner(params, k_steps=BATCH_K)
        br.tune(TUNE_HZ)
        br.process(iq)
        prof = profile_call(br._run_call)
        print(f"rounds profile {label}: {prof['ops'] / BATCH_K:.1f} device "
              f"kernels and copies per step, device time "
              f"{prof['busy_ms'] / BATCH_K:.3f} ms/step (torch.profiler, "
              f"one call of {BATCH_K} replays) [{dev['smi']}]")
        runners[label] = br
    times: dict = {}
    for label in ("rounds=0", f"rounds={ROUNDS}", f"rounds={ROUNDS}",
                  "rounds=0"):
        br = runners[label]
        ms = min(timed_ms(br._run_call) for _ in range(3)) / BATCH_K
        times.setdefault(label, []).append(ms)
        s = br.geo.samples_per_step
        print(f"rounds timing {label}: {ms:.3f} ms/step, the replays alone "
              f"(best of 3 calls of {BATCH_K}), {s / ms / 1e3:.3f} complex "
              f"Msamples/s [{dev['smi']}]")
    ratio = sum(times["rounds=0"]) / sum(times[f"rounds={ROUNDS}"])
    print(f"rounds timing: rounds=0 / rounds={ROUNDS} = {ratio:.3f}")
    fused_fft1.launches = counted


def phase_mxu(dev: dict, device="cuda", tiny: bool = False) -> int:
    """The matmul-DFT fft1 variants.  Returns the kernel's launches on
    these paths (0)."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    on_card = torch.device(device).type == "cuda"
    base = flagship_params(tiny=tiny)
    geo = derive_geometry(base)
    iq = make_input(geo)
    shapes = flagship_shapes(geo)
    xla = run_rx(dataclasses.replace(base, fft1_variant="xla"), iq, device)
    mxu_p = dataclasses.replace(base, fft1_variant="mxu")
    bf_p = dataclasses.replace(base, fft1_variant="mxu_bf16")
    fused_fft1.launches = 0
    mxu = run_rx(mxu_p, iq, device)
    launches = fused_fft1.launches
    check_outputs(mxu, shapes)
    print(f"mxu: fft1 {geo.fft1_size} as the four-step matmul DFT, "
          f"{len(mxu)} steps, fused_fft1 launches {launches}")
    compare_runs(mxu, xla, shapes, "mxu: ", what="mxu vs xla on the card")
    if on_card:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = run_rx(mxu_p, iq, device)
            left_on = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        for i, (a, b) in enumerate(zip(mxu, tf32)):
            equal_outputs(a, b, f"mxu with TF32 switched on, step {i}")
        if not left_on:
            raise AssertionError("mxu: the caller's TF32 setting was not "
                                 "restored")
        print(f"mxu: with torch.backends.cuda.matmul.allow_tf32 = True set "
              f"by the caller, every output field of the {len(tf32)} steps "
              f"bit-equal to the run with it off; the setting restored "
              f"(now {torch.backends.cuda.matmul.allow_tf32})")
    fused_fft1.launches = 0
    bf = run_rx(bf_p, iq, device)
    launches += fused_fft1.launches
    check_outputs(bf, shapes)
    for k in shapes:
        if k in ("blanker_fitted", "blanker_cleared"):
            continue
        worst = max(max_rel(getattr(a, k), getattr(b, k))
                    for a, b in zip(bf, xla))
        print(f"mxu_bf16 against xla on {device} (another function: bf16 "
              f"operands), {k} max_rel {worst:.3e}")
    same_signs = sum(torch.equal(torch.sign(a.liminfo), torch.sign(b.liminfo))
                     for a, b in zip(bf, xla))
    print(f"mxu_bf16: blanker_fitted {[int(o.blanker_fitted) for o in bf]} "
          f"(xla {[int(o.blanker_fitted) for o in xla]}); liminfo sign "
          f"pattern as xla's in {same_signs} of {len(bf)} steps")
    if on_card:
        # the same function on the CPU: the card's bf16 path to phase 4's
        # bars
        cpu = outputs_on(run_rx(bf_p, iq, "cpu"), device)
        compare_runs(bf, cpu, shapes, "mxu_bf16: ", what="card vs CPU")
    if launches:
        raise AssertionError("mxu: the fused fft1 kernel was launched on a "
                             "matmul-DFT path")
    return launches


def tilted_filtercorr(geo) -> np.ndarray:
    """calibration.make_filtercorr of a response tilted by 8 dB across the
    band, with a 1.6 dB ripple and a phase ramp."""
    from linrad_tpu_torch.calibration import make_filtercorr
    k = np.fft.fftfreq(geo.fft1_size)
    resp = ((10 ** (0.2 * k) * (1.0 + 0.1 * np.cos(12 * np.pi * k)))
            * np.exp(1j * 3.0 * k))
    return make_filtercorr(resp)


def phase_calibration(dev: dict, device="cuda", tiny: bool = False) -> int:
    """A non-unity filtercorr through the kernel.  Returns the kernel's
    launches over the calibrated receiver's steps."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    base = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(base)
    cal = {"filtercorr": tilted_filtercorr(geo)}
    iq = make_input(geo)
    fused_fft1.launches = 0
    outs = run_rx(base, iq, device, cal)
    launches = fused_fft1.launches
    shapes = flagship_shapes(geo)
    check_outputs(outs, shapes)
    fc = np.abs(cal["filtercorr"][:, 0])
    print(f"calibration: filtercorr |gain| {fc.min():.4f}-{fc.max():.4f} "
          f"over {geo.fft1_size} bins, {len(outs)} steps, fused_fft1 "
          f"launches {launches}; blanker_fitted "
          f"{[int(o.blanker_fitted) for o in outs]}")
    if torch.device(device).type == "cuda" and launches != STEPS:
        raise AssertionError(f"calibration: expected {STEPS} launches")
    compare_runs(outs, run_rx(dataclasses.replace(base, fft1_variant="xla"),
                              iq, device, cal), shapes, "calibration: ")
    return launches


def fleet_dials(geo, r: int) -> list:
    """r dials spread over the band away from the strong carrier, each a
    third of an fftx bin off the bin centre (fractional tuning)."""
    bin_hz = geo.timf1_sampling_speed / geo.fftx_size
    return [f + bin_hz / 3.0 for f in multi_dials(geo, r)]


def phase_fleet(dev: dict, device="cuda", tiny: bool = False,
                r: int = FLEET_R) -> int:
    """FleetRunner over r streams.  Returns the kernel's launches over its
    FLEET_STEPS steps, as the runner counts them."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import FleetRunner
    on_card = torch.device(device).type == "cuda"
    p = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(p)
    dials = fleet_dials(geo, r)
    iq = np.stack([make_input(geo, steps=FLEET_STEPS, tones=(f,))[:, 0]
                   for f in dials])
    with warnings.catch_warnings():
        # an operation without a batching rule would loop over the streams
        warnings.filterwarnings("error", message=VMAP_SLOW_PATH)
        fl = FleetRunner(p, r, k_steps=FLEET_K, outputs=FLEET_FIELDS,
                         device=device)
        fl.tune(dials)
        fused_fft1.launches = 0
        got = fl.process(iq)
    launches = fl.kernel_launches
    wrapper = fused_fft1.launches
    pool = graph_pool_bytes(fl.graphed.graph) if on_card else 0
    print(f"fleet: FleetRunner {r} streams x k_steps={FLEET_K} on "
          f"{fl.device}, {FLEET_STEPS} steps of {geo.samples_per_step} "
          f"samples each; {fl.kernels_per_replay} fused_fft1 node(s) per "
          f"replay, launches {launches} (wrapper calls {wrapper}); capture "
          f"{fl.graphed.capture_seconds:.3f} s, graph pool {pool} bytes "
          f"[{dev['smi']}]")
    if on_card and (fl.kernels_per_replay != 1 or launches != FLEET_STEPS
                    or wrapper != 0 or pool <= 0):
        raise AssertionError("fleet: expected one kernel launch per step for "
                             "all streams, from the replays")
    bb = geo.baseband_samples_per_step
    for f in FLEET_FIELDS:
        if got[f].shape != (r, FLEET_STEPS * bb, 1) \
                or not np.isfinite(got[f]).all():
            raise AssertionError(f"fleet: {f} has the wrong shape or is not "
                                 f"finite")
    peaks = [audio_peak_hz(torch.from_numpy(got["audio"][k, :, 0]),
                           geo.baseband_sampling_speed) for k in range(r)]
    print(f"fleet: audio peaks (Hz) {[round(float(x), 1) for x in peaks]}")
    if not tiny and any(abs(x - BFO_HZ) > 20.0 for x in peaks):
        raise AssertionError("fleet: a stream's tone is not at the BFO pitch")
    for k in sorted({0, r // 2, r - 1}):
        single = run_rx(p, iq[k], device, tune_hz=dials[k])
        equal = True
        worst = {}
        for f in FLEET_FIELDS:
            mine = torch.from_numpy(got[f][k])
            ref = torch.cat([getattr(o, f) for o in single]).cpu()
            equal = equal and torch.equal(mine, ref)
            worst[f] = (max_rel(mine[:bb], ref[:bb]),
                        max_rel(mine[bb:], ref[bb:]))
        print(f"fleet: stream {k} (dial {dials[k]:.2f} Hz) against a single "
              f"Receiver: bit-equal {equal}; " + "; ".join(
                  f"{f} step 0 max_rel {a:.3e}, steps 1-{FLEET_STEPS - 1} "
                  f"{b:.3e}" for f, (a, b) in worst.items()))
        bar0 = {"audio": START_AUDIO_TOL, "baseb": CHAIN_TOL_OTHER}
        bar = {"audio": CHAIN_TOL["audio"], "baseb": CHAIN_TOL_OTHER}
        if not tiny and any(a > bar0[f] or b > bar[f]
                            for f, (a, b) in worst.items()):
            raise AssertionError(f"fleet: stream {k} outside phase 4's bars")
    if on_card:
        phase_fleet_timing(dev, p, dials, iq, fl)
    return launches


def phase_fleet_timing(dev: dict, p, dials, iq: np.ndarray, fl) -> None:
    """R = 1 and R = FLEET_R in turns; the profiled call; the fold."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import FleetRunner
    from linrad_tpu_torch.utils.timing import graph_ms
    counted = fused_fft1.launches
    one = FleetRunner(p, 1, k_steps=FLEET_K, outputs=FLEET_FIELDS)
    one.tune(dials[:1])
    fleets = {1: (one, iq[:1]), fl.n: (fl, iq)}
    s = fl.geo.samples_per_step
    for r in (1, fl.n):
        runner, x = fleets[r]
        runner.process(x)
        prof = profile_call(runner._run_call)
        kern = sum(n for name, _, n in prof["by_name"]
                   if "fused_fft1_kernel" in name)
        print(f"fleet profile R={r}: {prof['ops'] / FLEET_K:.1f} device "
              f"kernels and copies per step, fused_fft1_kernel run {kern} "
              f"times in {FLEET_K} replays, device time "
              f"{prof['busy_ms'] / FLEET_K:.3f} ms/step (torch.profiler) "
              f"[{dev['smi']}]")
        # the runner's count says one launch per replay; here the
        # profiler must not see more (a loop over the streams would show
        # R per replay).  It has been seen to drop a few of a call's
        # 66,000 events, so fewer than K are reported, not failed.
        if not 1 <= kern <= FLEET_K:
            raise AssertionError("fleet: the device ran the kernel more "
                                 "than once per replay, or never")
    times: dict = {}
    for r in (1, fl.n, fl.n, 1):
        runner, x = fleets[r]
        whole = timed_ms(lambda: runner.process(x)) / FLEET_STEPS
        alone = min(timed_ms(runner._run_call) for _ in range(3)) / FLEET_K
        times.setdefault(r, []).append(alone)
        print(f"fleet timing R={r}: {whole:.3f} ms/step for whole process() "
              f"calls, {alone:.3f} ms/step the replays alone (best of 3 "
              f"calls of {FLEET_K}); aggregate {r * s / alone / 1e3:.3f} "
              f"complex Msamples/s ({s / alone / 1e3:.3f} per stream) "
              f"[{dev['smi']}]")
    print(f"fleet timing: R={fl.n} step / R=1 step = "
          f"{sum(times[fl.n]) / sum(times[1]):.3f}; graph pools "
          f"{graph_pool_bytes(one.graphed.graph)} bytes at R=1, "
          f"{graph_pool_bytes(fl.graphed.graph)} at R={fl.n}")
    frames = torch.zeros((fl.n, fl.geo.fft1_frames_per_step,
                          fl.geo.fft1_size, 1), dtype=torch.complex64,
                         device=fl.device)
    fold = graph_ms(lambda: frames.permute(1, 2, 0, 3).contiguous(), 50, 20)
    print(f"fleet: the vmap rule's fold of {tuple(frames.shape)} frames into "
          f"{(frames.shape[1], frames.shape[2], fl.n)} alone: {fold:.5f} ms "
          f"(device-only, CUDA graph) [{dev['smi']}]")
    fused_fft1.launches = counted


# stage functions of pipeline/chain.py: (module attribute of chain, name)
STAGES = [(None, "fft1_step"), ("sellim_ops", "update_liminfo"),
          ("sellim_ops", "liminfo_gains"), (None, "timf2_step"),
          ("blanker_ops", "update_noise_floor"),
          ("blanker_ops", "clever_blanker"),
          ("blanker_ops", "stupid_blanker"), (None, "fft2_transform"),
          (None, "spur_subtract_step"), (None, "fft2_power_update"),
          (None, "mix1_step"), (None, "fft3_step"), (None, "mix2_step"),
          ("demod_ops", "bfo_ssb"), ("agc_ops", "agc"), (None, "expander"),
          (None, "squelch_step")]


def stage_split(dev: dict, k_sub: int = MULTI_K, steps: int = 6) -> None:
    """Diagnostic, not part of the smoke run (``python3 chip_smoke.py
    --stages``): the multi-receiver step of phase 8 with a device
    synchronisation before and after every stage function, so that each
    stage's wall time holds its own launches and device work.  Prints ms
    per stage and step, averaged over ``steps`` steps after 2 of warm-up.
    The synced step is slower than the free-running one."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline import chain
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    p = multi_params("pallas", False)
    geo = derive_geometry(p)
    dials = multi_dials(geo, k_sub)
    iq = make_input(geo, seed=5, steps=steps + 2, tones=dials,
                    tone_amplitude=MULTI_TONE_AMPLITUDE,
                    spur=(MULTI_SPUR_HZ, MULTI_SPUR_AMPLITUDE))
    rx = MultiReceiver(p, k_sub)
    for k, f in enumerate(dials):
        rx.tune_subch(k, f)
    # a slot on each carrier, as the manager sets them in phase 8
    n, fs = geo.fftx_size, geo.timf1_sampling_speed
    rx.state.spur.bins[0] = int(round(CARRIER_HZ / fs * n)) % n
    rx.state.spur.bins[1] = int(round(MULTI_SPUR_HZ / fs * n)) % n
    s = geo.samples_per_step
    blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
              for i in range(steps + 2)]
    spent = {}

    def timed(fn, name):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    saved = []
    for mod, name in STAGES:
        owner = chain if mod is None else getattr(chain, mod)
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, timed(getattr(owner, name), name))
    try:
        for b in blocks[:2]:
            rx.process_block(b)
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in blocks[2:]:
            rx.process_block(b)
        torch.cuda.synchronize()
        whole = time.perf_counter() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    print(f"stage split, MultiReceiver K={k_sub}, synced wall ms per stage "
          f"over {steps} steps [{dev['smi']}]:")
    for name, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {1e3 * sec / steps:.3f}")
    rest = whole - sum(spent.values())
    print(f"  outside the stages: {1e3 * rest / steps:.3f}; whole synced "
          f"step {1e3 * whole / steps:.3f}")


def main() -> None:
    dev = phase_device()
    phase_build()
    if sys.argv[1:] == ["--stages"]:
        stage_split(dev)
        stage_split(dev, k_sub=1)
        return
    if sys.argv[1:] == ["--regimes"]:
        replay_regimes(dev)
        return
    kern = phase_kernel(dev)
    launches = phase_main()
    phase_timing(dev)
    eme_launches, eme_rx, eme_iq = phase_eme()
    phase_eme_timing(dev, eme_rx, eme_iq)
    launches += eme_launches
    launches += phase_multi(dev)
    launches += phase_real(dev)
    launches += phase_batch(dev)
    launches += phase_checkpoint(dev)
    launches += phase_file(dev)
    phase_latency(dev)
    phase_radar_wfm(dev)
    launches += phase_rounds(dev)
    launches += phase_mxu(dev)
    launches += phase_calibration(dev)
    launches += phase_fleet(dev)
    print(json.dumps({"kernels": [{
        "name": "fused_fft1", "route": "cuda",
        "source": "linrad_tpu_torch/csrc/fused_fft1.cu",
        "replaces": "linrad_tpu/ops/pallas_fft.py:59",
        "launches": launches, **kern[MAIN_SHAPE],
        "by_shape": {"x".join(map(str, shape)): v
                     for shape, v in kern.items()}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
