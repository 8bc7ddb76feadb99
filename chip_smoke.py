"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA, print the card, its power limit, the torch and
            CUDA versions; turn TF32 off for matmul and cuDNN.
2. build    build the seven kernels of linrad_tpu_torch/csrc/ (the fused
            fft1, the blanker's fits, sellim's taper, the stupid blanker,
            the radar front's statistics, sellim's liminfo update, mix1's
            fractional-bin ramp) with nvcc (sm_90a),
            one nvcc each, all at once, and print the build seconds and
            what ptxas says of registers and spills.
3. kernel   fused_fft1 (kernel) against fused_fft1_reference (plain
            PyTorch) on the card at eleven shapes, the flagship's, the
            EME path's and the HSMS and NCW presets' among them, and
            three that reach the kernel's
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
3b. loops  the main path's hand-written loop kernels against their
            plain PyTorch versions on the card: blanker_fits (the blocked clever blanker's fits) on
            the arguments the pipeline hands it in eager steps of the
            flagship (65,536 samples, up to 64 fits), the EME path (two
            channels) and WCW (262,144 samples, 16 fits), under
            torch.func.vmap over 8 flagship steps as a fleet's streams
            (one launch), with a time shard's ineligible halos, on eleven
            crafted streams (FITS_EDGE_CASES: ties between blocks and
            between sub-blocks, NaN and +inf power, pulses on the first
            and last sample, a halo, two and three channels, windows
            across block boundaries, candidates on the padded stream's
            ends) and on streams of 1,048,576 and 2,097,152 samples, past
            the kernel's shared-memory plan (the bank read from L2, then
            wider sub-blocks): nfit exact, weak and pwr within 1e-5, NaN
            where the plain version has it, the arguments unchanged; per
            case us per fit and the kernel's shared-memory plan, and the
            ptxas lines of every instance;
            sellim_taper (the edge taper) on the flagship's arguments, on
            carriers at fft1 512, 2,048, 4,096, 8,192 and 16,384 (the
            widest one's budget lasts all 64 passes), at 32,768 and 65,536,
            on twelve crafted cases (TAPER_EDGE_CASES: ties, NaN gains,
            budgets above 64, the band's ends, a gain of 0 and weak bins
            with budget, the last two through the kernel's window loop),
            and under vmap over 8 streams and over 3 with a shared budget:
            NaNs where the plain version has them, signs exact, gains
            within 1e-6; per case the tiles' paths (closed form or window
            loop) as the kernel reports them, held to the precondition,
            and the kernel's tile size and ptxas lines;
            blanker_clear (the stupid blanker, two launches a call) on the
            arguments of eager flagship (65,536 x 1) and EME (131,072 x 2)
            steps, on twelve crafted cases (CLEAR_EDGE_CASES: nothing
            flagged, everything flagged, runs longer than two tiles, runs
            on the stream's ends and across tile edges, maxima at 4 floors
            and at the clamp, +inf and NaN power, a ragged S, three
            channels, pw 30, a floor of 0) and under vmap over 8 flagship
            streams and over 8 crafted ones, each with its own floor:
            weak', pwr' and the count bit-equal to the plain version's, the
            vmap call bit-equal to separate calls; its ptxas lines;
            radar_stats (frame_pulse_stats, the radar front's statistics)
            on the radar front's power of preset(RADAR) steps (64 x 2,048)
            at walk_steps 32, 0 and 64, on the crafted cases (STATS_CASES:
            noise, spikes, skirts, skirts stopped after 1-70 steps, a
            skirt longer than any walk, ties of the maximum, peaks on the
            row's ends) at every n of 256, 2,048, 2,050 and 4,096, 1, 64
            and 200 frames and walk_steps 0, 1, 4, 31, 32, 33 and 64, and
            under vmap over 8 of the front's steps: peak bins equal to the
            plain version's, floor and S/N within 1e-5 of it and the floor
            within 1e-5 of the mean outside the walks' ends recomputed in
            float64, the vmap call one launch bit-equal to separate calls;
            its ptxas lines;
            sellim_update (update_liminfo's front and back kernels around
            the taper) on the arguments of eager flagship (2,048 bins) and
            EME (4,096, two channels summed) steps, on sixteen crafted
            cases (UPDATE_EDGE_CASES: no strong bin, one, runs on the
            band's ends and across DC bin 0, +inf power, maxlevel 0, a
            passband over a segment, an old state of gains and counters,
            NaN power, real input, ties, long runs, every bin strong, 20
            groups, n 4,096 to 16,384) and under vmap over 8 flagship
            streams and over 8 crafted ones (a passband each, one shared):
            liminfo and liminfo_wait bit-equal to the plain version's, the
            front kernel's taper arguments bit-equal to the plain
            version's, its carrier threshold's gap printed, one launch of
            each kernel under vmap; first a probe that PyTorch's CUDA sums
            and means of rows of 3, 20 and 32 take the front kernel's
            order; its ptxas lines;
            mix1_ramp (mix1's fractional-bin ramp: its sums in XLA's CPU
            order, wrap, cos and sin, one launch) on the arguments of an
            eager flagship step (4,096 samples, one row), under vmap over
            8 of them as a fleet's streams, and on the EME receiver's
            per-frame fractions and slopes once its AFC holds the signal,
            then on the 108 crafted cases (RAMP_CASES: lengths 1 to 65,536,
            1, 8 and 24 rows, a fraction a row or a frame, slope or not):
            the ramp and the new phase bit-equal to the plain version's;
            first a probe that the kernel's remainder, -2 pi product, cosf
            and sinf are torch's on the card and that torch divides by a
            Python integer as the product with its float reciprocal; its
            bound the launch floor; its ptxas lines.  Two runs
            bit-identical, a replay from a CUDA graph bit-equal to the
            eager call.  Per case
            device_ms (graph replay), eager ms, the launch floor, bound_ms
            (the bytes these inputs need over 3.35 TB/s, or the operations
            of the iterations that run), the plain version's device_ms
            and kernels per call (at the flagship's shape also its eager
            ms and the kernel's device ops per call); no library call
            computes either loop.  Then the graphed
            flagship Receiver (8 steps) and BatchRunner (16) through the
            kernels against the same with the plain versions patched in,
            to phase 4's bars with the blanker counts and liminfo signs
            exact (step 0's agc_gain within 2e-4), what those bars read
            for plain fits with the pulse bank at bfloat16 (printed), and
            both runners' kernels and ms per replayed step in turns.
4. main     the flagship receive step (96 kHz IQ, 65,536 samples per
            step, fft1 2048 with the kernel) through Receiver for 8 steps
            of a weak keyed CW tone, Gaussian noise, impulse noise and a
            strong carrier; one kernel launch per step (per replay of the
            Receiver's graph), and one of each loop kernel, mix1_ramp
            among them (their counts set to 0 before and read after); the
            same input through a
            Receiver on torch.fft ("xla") must agree within the stated
            bars.
5. timing   eager step time and complex Msamples/s for both receivers.
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
            read of fft2_power per step) and with its bare step (the
            graph's replay on fixed per-frame tuning, no read), in turns.

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

19. weak    the weak-signal decode and the operator's path.  (a) The
            repository's qualification (tests/test_weak.py::
            TestWeakSignalQualification) at its full width: 96 kHz IQ,
            fft1 8192, 262,144 samples per step, AFC, coherent detector;
            at -2 dB (seed 1000) and -6 dB (seed 1001) in 2500 Hz
            decode_morse_ml of the card's baseband must read "CQ DX DE
            SM5BSZ" exactly; the baseband against the same Receiver on
            the CPU.  (b) test_full_chain_decode's configuration (fft1
            2048, 65,536 samples per step) with the fused fft1: one
            launch per step; decode_morse exact; against a torch.fft
            receiver to phase 4's bars.  (c) TapPublisher and WebGui on
            that receiver on 127.0.0.1: the UDP audio and baseband taps
            equal the card's outputs bit for bit, /status.json and
            /waterfall.bmp are fetched; SsbTxStreamer with its resampler
            on the card against its CPU run within 1e-5, and its ms per
            block.  Each part's seconds.

20. sharded the flagship at full width split over 4 time shards on one
            card (ShardedReceiver(devices=["cuda:0"] * 4): 16,384 samples
            and 16 fft1 frames a shard, 16 fits a shard) for 8 steps of
            phase 4's input: no fused kernel (the JAX package takes none
            under sharding); against the same over ["cpu"] * 4 for 6
            steps (counts and liminfo signs exact, audio 1e-3 in step 0
            and 1e-4 after, every other float 1e-4); against the card's
            single-device Receiver with the stupid blanker off, as the JAX
            test compares them (fits >= single - 1, baseb max|diff|/max
            under 0.02; with it on, the per-step numbers are printed).
            ShardedBatchRunner(k_steps=4) bit-equal to the streamed
            receiver; ShardedMultiReceiver at K = 3, each row against a
            ShardedReceiver on its dial within 1e-4; DistGroup at world
            size 1 (NCCL, 4 local shards) bit-equal to LocalGroup;
            FleetRunner(flagship, 8, device=["cuda:0", "cuda:0"])
            bit-equal to the two 4-stream runners it composes and against
            FleetRunner(device="cuda:0") to phase 4's bars, one fused_fft1
            node per device's graph (2 per replayed step).  Then eager sharded step
            ms and kernels per step at d = 1, 2, 4, 8 in turns, and the
            parity report's five configurations at full width (all pass).

21. graphed  Receiver, MultiReceiver and the sharded classes on one card
            replaying their step from CUDA graphs (their default on a
            card), held against the same classes with graphed=False, every
            RxOutputs field bit for bit: the flagship over phase 4's 8
            steps (one kernel launch per replay, 8 in all); the EME
            configuration over phase 6's 12 steps through the AFC's lock
            (the AFC trajectory equal, the one-bin and the coherent
            structure's graphs each replayed); MultiReceiver K = 24 over
            phase 8's 10 steps with its spur manager (slots equal); phase
            11's EME checkpoint saved and resumed by graphed receivers;
            ShardedReceiver over ["cuda:0"] * 4 on the sharded test's
            coherent-AFC configuration (16,384 baseband samples a step),
            ShardedBatchRunner(k_steps=4) against the streamed receiver and
            ShardedMultiReceiver K = 3.  Then, every receiver captured
            first and after a profiler pass and an eager loop (the warm-up
            that ends in the fast replay regime, ``--regimes``), ms per
            step graphed and eager in turns for the flagship, the EME
            configuration (and its graph alone, without the AFC's read),
            MultiReceiver at K = 1 and K = 24; capture seconds and graph
            pool bytes per structure; host reads per step.

22. presets the nine Linrad modes, preset(RxMode.X) at its published
            width (WCW fft1 8192 with the AFC, NCW 4096, HSMS 512 with
            16,384 samples a step, SSB, FM, AM, TXTEST and RADAR 2048,
            QRSS 16384 with fft2 131072 and the AFC), each on the input
            that fits its mode (linrad_tpu_torch/io/modeinput.py), the
            dial between two fft1 bins, 3 steps (5 with the AFC: it
            acquires after the 4th, and the 5th runs the per-frame
            structure's graph), through the Receiver a user makes: the
            passes that each step's sellim_taper inputs need (recorded
            from the eager run) and whether the kernel's closed form
            holds on them; one mix1_ramp call recorded in each graph and
            its launches by the replays; the graphed run bit-equal to
            graphed=False;
            against the same
            run on the CPU to the parity bars of ROADMAP (counts, liminfo
            signs and the AFC status per step exact; step 0's audio and
            agc_gain, the pipeline's fill left out, to 5e-3); where fft1
            is at most 4,096 points, fft1_variant="pallas" (one kernel
            launch per replay) against the preset's torch.fft run to
            phase 4's bars.  Then, after a profiler pass and an eager
            loop, ms per step and complex Msamples/s graphed and eager in
            turns, device kernels per step of both, capture seconds and
            graph pools; a table of the nine.
23. radar mode  preset(RADAR) with the fused fft1: its receiver's
            front end (weak/radar.py:RadarFront: fft1, the frames' power
            and frame_pulse_stats, one CUDA graph per step) feeds a
            RadarTracker on the card over 20 steps of a pulse train every
            40 frames with a doppler-shifted echo 8 frames later: the
            graph bit-equal to the eager front in every step, a tracker
            fed the card's power as a tensor (its own statistics on the
            card) deciding the same, lock, pulse separation and echo
            range equal to the CPU run's; one launch of the fused fft1
            and one of radar_stats per replay.
            Then ms per step of the graphed and the eager front in
            turns, kernels per replay and per display update.
24. fft2    fft2_step at the flagship geometry: three steps of seeded
            noise bit-equal to fft2_transform then fft2_power_update,
            the last with TF32 switched on by the caller; make_tail's
            zeros in the state's tail shape on the card.  No fused_fft1
            launch.
25. band    the band station (rxbench/configs/ssb-multi24-2msps.json:
            2 MS/s, fft1 32,768 through torch.fft, fft2 65,536,
            1,048,576 samples a step) on the cell's own traffic
            (rxbench/generators/band.py): sellim_update at n 32,768 on
            the crafted case and on arguments recorded from eager steps,
            and blanker_fits on the step's 1,048,576 samples (the bank
            from L2), each bit-equal to its plain version; then
            MultiReceiver with the configuration's 24 sub-receivers,
            graphed against graphed=False, every RxOutputs field bit for
            bit; ms a block of both in turns, the graph's capture seconds,
            pool and the peak device memory.  No fused_fft1 launch.

Every phase makes its receivers as a user would, so on the card they
replay graphs; the phases count the kernel's launches from the replays
(the kernel calls recorded in each graph times its replays, through
``recorded_fft1``), and those that time, profile or patch the eager step
(5, 8's timing, 20's timing, ``--stages``) pass graphed=False.

``python3 chip_smoke.py --stages`` runs phases 1 and 2 and then, instead
of the smoke run, a diagnostic: the synced wall time of every stage of
the multi-receiver step at K = 24 and K = 1, with its device kernels.
``--regimes`` likewise prints the graphed flagship step's time at points
of one process's life (a fresh runner, after the profiler's first start,
after another capture, after an eager loop).

It prints the whole run's seconds, a JSON line describing every kernel
of the paths (fused_fft1's launches summed over the flagship, EME,
multi-receiver, real-input, batch, checkpoint, file, rounds, mxu,
calibration, fleet, CW decode, phase 20's single-device and fleet runs,
phase 21's graphed receivers, phase 22's "pallas" presets and phase 23's
radar front, each counted from zero; times at the flagship's shape, and
per shape under "by_shape"; the loop kernels' launches over phase 4's
main path, their times at the flagship's arguments, and per case under
"by_case"), then, as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
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
                 # the HSMS and NCW presets with "pallas"
                 (64, 512, 1), (64, 4096, 1),
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
# the weak-signal decode and the operator's path (phase 19): the
# repository's qualification (tests/test_weak.py::TestWeakSignalQualification)
# at its full width, two (SNR dB in 2500 Hz, seed) runs that the JAX
# package decodes exactly; the CW decode of test_full_chain_decode
SHARD_D = 4
SHARD_STEPS = 8
SHARD_CPU_STEPS = 6
SHARD_K = 4
SHARD_SUB = 3
SHARD_SUB_STEPS = 4
SHARD_DIST_STEPS = 4
SHARD_TIME_D = (1, 2, 4, 8)
SHARD_TIME_STEPS = 4
# card against CPU: audio 1e-3 in step 0 (the start-up, as phase 4's) and
# 1e-4 after, every other float 1e-4; against the single-device step, the
# JAX package's own bars (tests/test_sharded.py:132-136)
SHARD_TOL = {"audio": 1e-4}
SHARD_SINGLE_BASEB = 0.02
SHARD_SUB_TOL = 1e-4
QUAL_MSG = "CQ DX DE SM5BSZ"
QUAL_RUNS = ((-2.0, 1000), (-6.0, 1001))
QUAL_FC = 10_000.0
CW_MSG = "CQ CQ DE SM5BSZ"
CW_TUNE_HZ = 12_000.0
TX_BLOCKS = 32
TX_TOL = 1e-5
LOOPBACK = "127.0.0.1"
# the receivers from CUDA graphs (phase 21): the sharded AFC configuration's
# dial and steps, as tests/test_torch_sharded.py's "afc-coherent"
AFC_SHARD_HZ = 10_000.0
AFC_SHARD_STEPS = 7
PRESET_DIAL_HZ = 10_000.0     # between two fft1 bins in every preset
PRESET_STEPS = 3
PRESET_AFC_STEPS = 5          # the AFC acquires after the 4th step
PRESET_TIME_STEPS = 4
# card against CPU: the parity bars of ROADMAP
PRESET_TOL = {"audio": 2.3e-4, "fft2_power": 1e-6, "liminfo": 1e-5}
PRESET_START_TOL = 5e-3       # step 0's AGC start-up (ROADMAP queue 3)
PRESET_START_S = 0.2
PRESET_FILL_LEVEL = 1e-3
PALLAS_MAX_N = 4096           # the largest fft1 the fused kernel takes
RADAR_MODE_STEPS = 20         # 1,280 frames: the lock after 500, 32 pulses
RADAR_TIME_STEPS = 8
RADAR_UPDATES = 64            # display updates timed together
RADAR_TX_BIN, RADAR_SEP, RADAR_WIDTH, RADAR_DELAY = 100, 40, 3, 8
RADAR_DOPPLER = 5


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max(max|a|, max|b|), in double precision."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    a = a.detach().to(wide)
    b = b.detach().to(wide)
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return (a - b).abs().max().item() / scale


def recorded_fft1() -> int:
    """fused_fft1 calls recorded into CUDA graphs so far: handed to the
    runners, which count the kernel's launches per replay with it."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    return fused_fft1.captured


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
    """Every kernel of csrc/ built at once, one nvcc each."""
    from linrad_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, (_lib, info) in built.items():
        print(f"build {name}: {info['path']} (nvcc "
              f"{info['build_seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "smem", "spill",
                                       "error")):
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


# ---- phase 3b: the loop kernels ---------------------------------------

# The hand kernels of device loops and the JAX loops they replace; the
# case of each kernel's report at its main path's shape
LOOP_KERNELS = (("blanker_fits", "linrad_tpu/ops/blanker.py:322"),
                ("sellim_taper", "linrad_tpu/ops/sellim.py:150"),
                ("blanker_clear", "linrad_tpu/ops/blanker.py:449"),
                ("radar_stats", "linrad_tpu/weak/radar.py:84"),
                ("sellim_update", "linrad_tpu/ops/sellim.py:92"),
                ("mix1_ramp", "linrad_tpu/ops/mix1.py:185"))
LOOP_MAIN_CASE = {"radar_stats": "radar"}
LOOP_FITS_TOL = 1e-5     # weak and pwr against the plain version: max_rel
LOOP_TAPER_TOL = 1e-6    # the tapered gains: max_rel; the signs exact
# The chain through the loop kernels against the same with their plain
# versions: step 0's audio and agc_gain carry the AGC's start-up (see
# START_AUDIO_TOL), which amplifies the blanker's float32 differences
# (weak 2.6e-7 apart): agc_gain measured 1.01e-4 on an H100 in step 0,
# 4.1e-7 from step 1 on, where the bars are phase 4's.  Step 0's agc_gain
# bar sits between that reading and the 2.79e-4 of plain fits with the
# pulse bank at bfloat16 (``lowered_fits``), which a bar of three times
# the reading, MULTI_START_TOL's margin, would pass.
LOOP_START_TOL = {"audio": START_AUDIO_TOL, "agc_gain": 2e-4}
LOOP_STREAMS = 8         # the fleet's streams under torch.func.vmap
LOOP_HALO = 2048         # the eligible case's halos at both ends
# fft1 sizes of the taper: HSMS, the flagship, NCW, WCW, QRSS
TAPER_MODES = ("HSMS", None, "NCW", "WCW", "QRSS")


def loop_counts() -> dict:
    """The loop kernels' launch counts by name."""
    from linrad_tpu_torch.ops import blanker as bl
    from linrad_tpu_torch.ops import mix1 as mx
    from linrad_tpu_torch.ops import sellim as sl
    return {"blanker_fits": bl.fits_count, "sellim_taper": sl.taper_count,
            "blanker_clear": bl.clear_count,
            "sellim_update": sl.update_count, "mix1_ramp": mx.ramp_count}


def vmap_one_launch(kernel: str, run, each=None) -> None:
    """run(), a call under torch.func.vmap, checked to be one launch of
    ``kernel`` (its count as ``utils/cuda_build.COUNTS`` holds it) and,
    where ``each`` is given (it returns the separate calls' outputs), the
    same bits as those stacked."""
    from linrad_tpu_torch.utils import cuda_build
    count = cuda_build.COUNTS[kernel]
    before = count.launches
    got = run()
    if count.launches != before + 1:
        raise AssertionError(f"{kernel} under vmap: expected one launch")
    if each is not None and not all(same_bits(torch.stack(v), g)
                                    for v, g in zip(zip(*each()), got)):
        raise AssertionError(f"{kernel} under vmap differs from separate "
                             f"calls")


def record_calls(module, name: str, run) -> list:
    """The positional arguments of every call of ``module.name`` while
    ``run()`` runs; each call goes on to the function."""
    real = getattr(module, name)
    seen = []

    def recording(*args):
        seen.append(args)
        return real(*args)

    setattr(module, name, recording)
    try:
        run()
    finally:
        setattr(module, name, real)
    return seen


def with_loop_references(run, fits=None):
    """run() with the loop kernels' wrappers replaced, where the pipeline
    calls them, by their plain versions (as ``stage_split`` patches the
    stage functions), or the fits by ``fits`` where given."""
    from linrad_tpu_torch.ops import blanker as bl
    from linrad_tpu_torch.ops import mix1 as mx
    from linrad_tpu_torch.ops import sellim as sl
    saved = (bl.blanker_fits, sl.sellim_taper, bl.blanker_clear,
             sl.sellim_update, mx.mix1_ramp)
    bl.blanker_fits = fits or bl._blanker_fits_reference
    sl.sellim_taper = sl._sellim_taper_reference
    bl.blanker_clear = bl._blanker_clear_reference
    sl.sellim_update = sl._update_liminfo_reference
    mx.mix1_ramp = mx._frac_ramp_reference
    try:
        return run()
    finally:
        (bl.blanker_fits, sl.sellim_taper, bl.blanker_clear,
         sl.sellim_update, mx.mix1_ramp) = saved


def plain_updates(run) -> list:
    """The arguments of every sellim_update call while ``run()`` runs,
    each call going to the plain version instead (which calls
    sellim_taper: the kernels' path calls the taper's launch itself)."""
    from linrad_tpu_torch.ops import sellim as sl
    real, seen = sl.sellim_update, []

    def plain(*args):
        seen.append(args)
        return sl._update_liminfo_reference(*args)

    sl.sellim_update = plain
    try:
        run()
    finally:
        sl.sellim_update = real
    return seen


def loop_args(p, iq: np.ndarray, tune_hz: float, steps: int,
              device="cuda") -> tuple:
    """The arguments of blanker_fits, of sellim_taper, of blanker_clear
    and of sellim_update in each of ``steps`` eager steps of a Receiver of
    p on the card (the update through its plain version, so that the
    taper's arguments are the pipeline's)."""
    from linrad_tpu_torch.ops import blanker as bl
    from linrad_tpu_torch.ops import sellim as sl
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, device=device, graphed=False)
    rx.tune(tune_hz)
    s = rx.geo.samples_per_step
    taper, clear = [], []

    def run():
        clear.extend(record_calls(bl, "blanker_clear", lambda: [
            rx.process_block(iq[i * s:(i + 1) * s]) for i in range(steps)]))

    def run_taper():
        taper.extend(record_calls(sl, "sellim_taper", run))

    fits = []
    updates = plain_updates(lambda: fits.extend(
        record_calls(bl, "blanker_fits", run_taper)))
    return fits, taper, clear, updates


def valid_fits(args: tuple) -> int:
    """The fits whose candidate is above the threshold, as the plain
    version meets them: the iterations the kernel runs before it stops."""
    from linrad_tpu_torch.ops import blanker as bl
    calls = record_calls(bl, "_fit_subtract",
                         lambda: bl._blanker_fits_reference(*args))
    return sum(bool(c[5]) for c in calls)


def taper_passes(lim: torch.Tensor, budget: torch.Tensor) -> int:
    """The passes the kernel runs: up to the first that changes no bin."""
    from linrad_tpu_torch.ops import sellim as sl
    for k in range(1, sl.TAPER_STEPS + 1):
        new, budget = sl._taper_pass(lim, budget)
        if torch.equal(new, lim):
            return k
        lim = new
    return sl.TAPER_STEPS


# A powf(., 0.9f) counted as FP32 operations: CUDA's powf is a logarithm,
# a multiply and an exponential in extended precision, about 20 of them.
POWF_OPS = 20


def taper_ops(lim: torch.Tensor, budget: torch.Tensor) -> int:
    """The operations sellim_taper needs on (lim, budget), as its closed
    form does them: a dozen a bin (the nearest nonzero bin on each side,
    the reach test, the pick), and for each source that lights (gain > 0,
    budget >= 1) one chain of powf as long as the farther of its two
    fronts reaches: at most 64 bins, at most its budget, and short of the
    next nonzero bin or the band's end."""
    n = lim.shape[-1]
    lims = lim.reshape(-1, n).cpu().numpy()
    budgets = np.broadcast_to(budget.cpu().numpy(), lim.shape).reshape(-1, n)
    ops = 12 * lims.size
    for lw, bw in zip(lims, budgets):
        nz = np.flatnonzero(lw != 0)
        gap_r = np.diff(np.append(nz, n))
        gap_l = np.diff(np.insert(nz, 0, -1))
        src = (lw[nz] > 0) & (bw[nz] >= 1)
        by_budget = np.floor(np.minimum(bw[nz], 64.0))
        chain = np.maximum(np.minimum(by_budget, gap_r - 1),
                           np.minimum(by_budget, gap_l - 1))
        ops += POWF_OPS * int(chain[src].sum())
    return ops


def taper_spectrum(n: int, seed: int) -> np.ndarray:
    """An averaged fft1 power spectrum: noise, a narrow strong carrier, a
    weaker one, and one about a ninetieth of the band wide, whose budget
    lasts all 64 passes from fft1 8,192 on."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    p = 1e3 * rng.chisquare(4, size=n) / 4
    for centre, height, width in ((n // 5, 3e11, 1.5), (3 * n // 4, 5e9, 0.7),
                                  (n // 2 + n // 7, 1e12, n / 90)):
        p += height * np.exp(-0.5 * ((k - centre) / width) ** 2)
    return p.astype(np.float32)


def fits_bytes_ops(args: tuple, m: int) -> tuple[int, int]:
    """What one blanker_fits call must move and compute with m fits run:
    its inputs read once (the bank's rows those fits use), its outputs
    written once; per fit the two argmaxes, the window's arithmetic and
    the refresh of two blocks."""
    wpad, _pp, _cp, bmax, bank, _pf, _thr, _pw, _mp, _lead, s = args
    total, c = wpad.shape[-2:]
    nblk = bmax.shape[-1]
    pul = bank.shape[-1]
    r = wpad.numel() // (total * c)
    nbytes = r * (8 * total * c + 8 * total + 4 * nblk + 4 + 8 * s * c
                  + 4 * s + 4) + 8 * pul + 8 * pul * m
    ops = m * (nblk + 3 * (total // nblk) + 60 * pul * c)
    return nbytes, ops


def loop_case(dev: dict, name: str, label: str, kernel, plain, compare,
              nbytes: int, ops: int, floor: float, reps: int,
              plain_device: bool = True, main: bool = False) -> dict:
    """kernel() against plain() on the card (compare(got, want) returns
    max_abs_err and a text, and raises beyond the bars); two runs of the
    kernel and a replay of it from a CUDA graph give the same bits; then
    the times: device_ms (graph replays), eager ms, and, with
    ``plain_device``, the plain version's device_ms and its kernels per
    call (torch.profiler); at the ``main`` case (the main path's shape)
    also the kernel's device ops per call and the plain version's eager
    ms (a profile costs about a second, so the other cases skip it)."""
    from linrad_tpu_torch.utils.timing import cuda_ms, graph_ms
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err, text = compare(got, want)
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {label}: two runs differ")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        replayed = kernel()
    graph.replay()
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(replayed, got)):
        raise AssertionError(f"{name} {label}: the graph's replay differs "
                             f"from the eager call")
    ms = cuda_ms(kernel, reps)
    ms = 0.5 * (ms + cuda_ms(kernel, reps))
    device_ms = graph_ms(kernel, reps, 5)
    device_ms = 0.5 * (device_ms + graph_ms(kernel, reps, 5))
    plain_ms = cuda_ms(plain, 2) if main else None
    plain_device_ms = plain_kernels = None
    if plain_device:
        plain_device_ms = graph_ms(plain, 1, 3)
        plain_kernels = profile_call(plain)["ops"]
    kernels = profile_call(kernel)["ops"] if main else "not counted"
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_FP32_OPS_PER_S
    bound = max(by_bytes, by_ops)
    print(f"loops {name} {label}: {text}, max_abs_err {err:.3e}; two runs "
          f"bit-identical, graph replay bit-equal to eager; device_ms "
          f"{device_ms:.5f}, eager ms {ms:.5f}, launch_floor_ms "
          f"{floor:.5f}, {kernels} device op(s) per call; bound_ms "
          f"{bound:.6f} ({nbytes} bytes; by operations {by_ops:.6f}), "
          f"share of bound {bound / device_ms:.4f}; plain version: device_ms "
          f"{plain_device_ms if plain_device else 'not measured'}, eager ms "
          f"{plain_ms or 'not measured'}, {plain_kernels or 'not counted'} "
          f"device ops per call; library_ms none (no one PyTorch call "
          f"computes the loop) [{dev['smi']}]", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "plain_kernels": plain_kernels, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None, "launch_floor_ms": floor}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b hold the same bits (a NaN equals a NaN of the same bits)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_fits(got, want) -> tuple[float, str]:
    (kw, kp, kn), (rw, rp, rn) = got, want
    if not torch.equal(kn, rn):
        raise AssertionError(f"blanker_fits: nfit {kn.tolist()} != "
                             f"{rn.tolist()}")
    for k, r in ((kw, rw), (kp, rp)):
        if not torch.equal(k.isnan(), r.isnan()):
            raise AssertionError("blanker_fits: NaN where the plain version "
                                 "has none, or none where it has one")
    kw, kp, rw, rp = (x.nan_to_num() for x in (kw, kp, rw, rp))
    rel_w, rel_p = max_rel(kw, rw), max_rel(kp, rp)
    err = max((kw - rw).abs().max().item(), (kp - rp).abs().max().item())
    if rel_w > LOOP_FITS_TOL or rel_p > LOOP_FITS_TOL:
        raise AssertionError(f"blanker_fits: weak max_rel {rel_w}, pwr "
                             f"{rel_p} (bar {LOOP_FITS_TOL})")
    return err, (f"nfit {kn.tolist()} exact, weak max_rel {rel_w:.2e}, pwr "
                 f"{rel_p:.2e} (bar {LOOP_FITS_TOL})")


def compare_taper(got, want) -> tuple[float, str]:
    (kl,), (rl,) = got, want
    if not torch.equal(kl.isnan(), rl.isnan()):
        raise AssertionError("sellim_taper: NaN where the plain version has "
                             "none, or none where it has one")
    kl, rl = kl.nan_to_num(), rl.nan_to_num()
    if not torch.equal(torch.sign(kl), torch.sign(rl)):
        raise AssertionError("sellim_taper: the sign pattern differs")
    rel = max_rel(kl, rl)
    if rel > LOOP_TAPER_TOL:
        raise AssertionError(f"sellim_taper: max_rel {rel} (bar "
                             f"{LOOP_TAPER_TOL})")
    return (kl - rl).abs().max().item(), (
        f"signs exact, {int((kl > 0).sum())} gains tapered or limited, "
        f"max_rel {rel:.2e} (bar {LOOP_TAPER_TOL})")


def fits_case(dev: dict, label: str, args: tuple, floor: float,
              plain_device: bool = True, main: bool = False) -> dict:
    """blanker_fits on one stream's arguments, as the pipeline hands them:
    against its plain version, then its time per fit and how the kernel
    holds the stream (the bank in shared memory or read from L2, the
    sub-block width, the dynamic shared memory)."""
    from linrad_tpu_torch.ops import blanker as bl
    m = valid_fits(args)
    before = [a.clone() for a in args[:7]]
    nbytes, ops = fits_bytes_ops(args, m)
    wpad, bank = args[0], args[4]
    plan = bl.fits_plan(*wpad.shape, *bank.shape[::-1])
    rep = loop_case(dev, "blanker_fits",
                    f"{label} {tuple(wpad.shape)} x {args[8]}, {m} fits "
                    f"run", lambda: bl.blanker_fits(*args),
                    lambda: bl._blanker_fits_reference(*args), compare_fits,
                    nbytes, ops, floor, 20, plain_device, main)
    if not all(same_bits(a, b) for a, b in zip(args[:7], before)):
        raise AssertionError("blanker_fits changed an argument")
    rep["fits"] = m
    rep["us_per_fit"] = 1e3 * rep["device_ms"] / max(m, 1)
    rep["plan"] = plan
    print(f"loops blanker_fits {label}: {rep['us_per_fit']:.3f} us per fit "
          f"(device_ms over {m} fits; bound_ms {rep['bound_ms']:.6f}); "
          f"bank {'in shared memory' if plan['bank_shared'] else 'read from L2'}"
          f", sub-blocks of {plan['sub_block']}, {plan['shared_bytes']} B "
          f"of dynamic shared memory [{dev['smi']}]", flush=True)
    return rep


# Crafted streams for blanker_fits, held against the plain version here on
# the card and, through a numpy model of the kernel's index, on the CPU
# (tests/test_torch_loop_kernels.py): noise of sigma 10 with five pulses of
# the reference bank's shape and a few impulses, and per case ties between
# two blocks or two sub-blocks of one block, a NaN or +inf power at an
# active sample, pulses on the first and last sample, in a time shard's
# halos, two channels, three (the kernel's general instance), windows
# across a block boundary, and candidates on the padded stream's first
# and last sample.
FITS_EDGE_CASES = ("plain", "ties-blocks", "ties-sub-blocks", "nan", "inf",
                   "first-last", "halo", "two-channel", "three-channel",
                   "block-boundary", "padded-edges")
FITS_EDGE_S = 2_000      # 2,304 padded samples: 9 blocks, 72 sub-blocks
FITS_EDGE_FITS = 24
FITS_EDGE_THR = 3_600.0  # a noise floor of 100 at clever_bln_limit 6
FITS_BLOCK = 256         # the presets' blanker_block_size


def fits_edge_tables():
    """The pulse bank, phase function and pulse width of a flat response
    at fft1 2,048 (the flagship's)."""
    from linrad_tpu_torch.ops import blanker as bl
    return bl.make_refpulse_bank(np.ones(2048, np.complex128), 64)


def fits_edge_case(name: str, bank: np.ndarray) -> tuple:
    """(weak (S, C) complex64, pwr (S,) float32, eligible (S,) or None) of
    one crafted case; sample k sits at k + 64 of the padded stream."""
    rng = np.random.default_rng(FITS_EDGE_CASES.index(name))
    s = FITS_EDGE_S
    c = {"two-channel": 2, "three-channel": 3}.get(name, 1)
    x = 10.0 * (rng.normal(size=(s, c)) + 1j * rng.normal(size=(s, c)))

    def pulse(pos: int, amp, row: int = 128) -> None:
        lo, hi = max(pos - 32, 0), min(pos + 32, s)
        x[lo:hi] += bank[row, lo - pos + 32:hi - pos + 32, None] * amp

    for k, pos in enumerate((300, 650, 1020, 1390, 1760)):
        pulse(pos, 3000.0 * (1 + 0.1 * k) * np.exp(2j * np.pi * rng.random(c)),
              row=40 + 30 * k)
    x[rng.integers(0, s, 6)] += 3000.0
    eligible = None
    ties = {"ties-blocks": (300, 812),                  # blocks 1 and 3
            "ties-sub-blocks": (300, 340)}.get(name, ())   # one block
    for pos in ties:
        pulse(pos, 5000.0)
    if name == "first-last":
        pulse(0, 6000.0)
        pulse(s - 1, 7000.0)
    if name == "halo":
        eligible = np.ones(s, bool)
        eligible[:256] = eligible[-256:] = False
        pulse(100, 9000.0)                  # in the halos: never a
        pulse(s - 100, 9000.0)              # candidate centre
    if name == "block-boundary":
        pulse(512 - 64 + 3, 6000.0)         # windows across 512
        pulse(1280 - 64 - 2, 6000.0)        # and across 1,280
    weak = x.astype(np.complex64)
    pwr = (np.abs(weak) ** 2).sum(1).astype(np.float32)
    for pos in ties:
        pwr[pos] = np.float32(4e7)
    if name == "nan":
        pwr[1020] = np.nan
    if name == "inf":
        pwr[1020] = np.inf
    return weak, pwr, eligible


def pad_fits_args(weak: torch.Tensor, pwr: torch.Tensor,
                  active: torch.Tensor, tables: tuple,
                  max_pulses: int) -> tuple:
    """blanker_fits' arguments as _clever_blanker_blocked builds them from
    a stream, its power and its candidate centres; tables: (refbank,
    phasefunc, thr, pw)."""
    from linrad_tpu_torch.ops import blanker as bl
    refbank, phasefunc, thr, pw = tables
    s, pul = weak.shape[0], refbank.shape[1]
    total = max(-(-(s + 2 * pul) // FITS_BLOCK) * FITS_BLOCK, 2 * FITS_BLOCK)
    lead, trail = pul, total - s - pul
    ppad = bl._pad_rows(pwr, lead, trail)
    candp = torch.where(bl._pad_rows(active, lead, trail, False), ppad, -1.0)
    return (bl._pad_rows(weak, lead, trail), ppad, candp,
            candp.reshape(-1, FITS_BLOCK).amax(1), refbank, phasefunc, thr,
            pw, max_pulses, lead, s)


def fits_edge_args(name: str, device="cuda") -> tuple:
    """blanker_fits' arguments for one crafted case on ``device``."""
    bank, pf, pw = fits_edge_tables()
    weak, pwr, eligible = fits_edge_case(
        "plain" if name == "padded-edges" else name, bank)
    to = lambda x: torch.from_numpy(x).to(device)
    active = torch.ones(len(pwr), dtype=torch.bool, device=device) \
        if eligible is None else to(eligible)
    thr = torch.tensor(FITS_EDGE_THR, dtype=torch.float32, device=device)
    args = pad_fits_args(to(weak), to(pwr), active,
                         (to(bank), to(pf), thr, pw), FITS_EDGE_FITS)
    if name == "padded-edges":
        # every padded sample a candidate centre, the strongest on the
        # first and the last: their windows clamped into the stream
        wpad, ppad, _c, _b, *rest = args
        ppad = ppad.clone()
        ppad[0], ppad[-1] = 5e7, 6e7
        args = (wpad, ppad, ppad.clone(),
                ppad.reshape(-1, FITS_BLOCK).amax(1), *rest)
    return args


def past_plan_args(streams: list, repeat: int = 1) -> tuple:
    """blanker_fits' arguments for one stream of 1,048,576 samples times
    ``repeat`` (16 flagship steps: the recorded streams and their time
    reverses), whose candidate index leaves no room for the pulse bank in
    shared memory, and at ``repeat`` 2 none for sub-blocks of 32."""
    weak = torch.cat([a[0][a[9]:a[9] + a[10]] for a in streams])
    pwr = torch.cat([a[1][a[9]:a[9] + a[10]] for a in streams])
    weak = torch.cat([weak, weak.flip(0)] * repeat)
    pwr = torch.cat([pwr, pwr.flip(0)] * repeat)
    a = streams[0]
    return pad_fits_args(weak, pwr, torch.ones_like(pwr, dtype=torch.bool),
                         (a[4], a[5], a[6], a[7]), a[8])


def fits_vmap_case(dev: dict, streams: list, floor: float) -> dict:
    """blanker_fits under torch.func.vmap over the streams (each its own
    threshold): one launch of R blocks, against the plain version stream
    by stream."""
    from linrad_tpu_torch.ops import blanker as bl
    stack = [torch.stack([a[i] for a in streams]) for i in (0, 1, 2, 3, 6)]
    w, p, c, b, thr = stack
    bank, pf, pw, mp, lead, s = streams[0][4], streams[0][5], \
        *streams[0][7:]

    def kernel():
        return torch.func.vmap(lambda *x: bl.blanker_fits(
            *x[:4], bank, pf, x[4], pw, mp, lead, s))(w, p, c, b, thr)

    def plain():
        outs = [bl._blanker_fits_reference(*a) for a in streams]
        return tuple(torch.stack(v) for v in zip(*outs))

    vmap_one_launch("blanker_fits", kernel)
    each = [valid_fits(a) for a in streams]
    m = sum(each)
    nbytes, ops = fits_bytes_ops((w, p, c, b, bank, pf, thr, pw, mp, lead,
                                  s), m)
    rep = loop_case(dev, "blanker_fits",
                    f"vmap R={len(streams)} {tuple(w.shape)} x {mp}, {m} "
                    f"fits run in all", kernel, plain, compare_fits,
                    nbytes, ops, floor, 10, plain_device=False)
    # the streams' chains run side by side: time per fit of the longest
    rep["fits"] = m
    rep["us_per_fit"] = 1e3 * rep["device_ms"] / max(each)
    print(f"loops blanker_fits vmap: {rep['us_per_fit']:.3f} us per fit of "
          f"the longest chain ({max(each)} of {each}) [{dev['smi']}]",
          flush=True)
    return rep


# Crafted (lim, budget) pairs for sellim_taper, as update_liminfo builds
# them (lim the gain on strong segments and 0 elsewhere, budget width/4 + 1
# on them and 0 elsewhere) over random segments, held against the plain
# version here on the card and, through a numpy model of the kernel, on the
# CPU (tests/test_torch_loop_kernels.py): a tie between two fronts (at 11
# bins and at 1), a NaN gain with and without budget, adjacent segments of
# different gains and a negative gain, budgets 1.25 to 2.75, budgets above
# 64 (the passes' cap binds), sources on the band's first and last bins, a
# gap of 200 bins, a strong segment of gain 0 and weak bins with budget >=
# 1 (the closed form's precondition broken: the window loop), n 512 and
# 2,944 (not a multiple of the tile), and three of them stacked as a
# fleet's streams.
TAPER_EDGE_CASES = ("tie", "nan", "adjacent", "fractional",
                    "budget-above-64", "ends", "long-gap", "gain-zero",
                    "weak-budget", "n512", "n2944", "vmap")
TAPER_VMAP_CASES = ("tie", "nan", "gain-zero")


def taper_edge_case(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(lim, budget) float32 of one crafted case: (n,) each, or (3, n)
    for "vmap"."""
    if name == "vmap":
        return tuple(np.stack(x) for x in zip(
            *(taper_edge_case(c) for c in TAPER_VMAP_CASES)))
    rng = np.random.default_rng(TAPER_EDGE_CASES.index(name))
    n = {"n512": 512, "n2944": 2944}.get(name, 2048)
    lim = np.zeros(n, np.float32)
    bud = np.zeros(n, np.float32)

    def seg(lo: int, width: int, gain: float, budget=None) -> None:
        lim[lo:lo + width] = gain
        bud[lo:lo + width] = width / 4 + 1 if budget is None else budget

    def clear(lo: int, hi: int) -> None:
        lim[lo:hi] = bud[lo:hi] = 0.0

    for _ in range(n // 170):
        seg(int(rng.integers(0, n - 24)), int(rng.integers(1, 25)),
            float(rng.uniform(0.05, 1.0)))
    if name == "tie":
        clear(380, 620)
        seg(400, 40, 0.3)               # budgets 11: bin 450 is 11 bins
        seg(461, 40, 0.7)               # from both fronts
        seg(560, 4, 0.2)                # bin 564 one bin from both
        seg(565, 4, 0.9)
        seg(580, 8, 0.5)                # equal gains, 4 bins between
        seg(592, 8, 0.5)
    elif name == "nan":
        clear(640, 1300)
        seg(650, 40, 0.4)               # its front reaches 699, which
        seg(700, 10, np.nan)            # the NaN (budget 3.5) keeps dark
        seg(712, 48, 0.2)               # lights 711; 710 stays dark
        seg(1200, 1, np.nan, 0.5)       # a NaN without budget blocks
        seg(1210, 40, 0.5)              # nothing: 1201-1209 lit
    elif name == "adjacent":
        clear(280, 420)
        seg(300, 20, 0.1)
        seg(320, 10, 0.9)
        seg(330, 1, 2.0)
        seg(340, 1, -1.0, 5.0)          # lights and blocks nothing
        seg(345, 6, 0.6)
    elif name == "fractional":
        clear(800, 1000)
        for k, width in enumerate((1, 2, 3, 4, 7)):   # 1.25 ... 2.75
            seg(820 + 20 * k, width, 0.5)
    elif name == "budget-above-64":
        clear(200, 1900)
        seg(600, 300, 0.8)              # budget 76
        seg(1200, 262, 0.3)             # 66.5; 300 bins between
    elif name == "ends":
        clear(0, 40)
        clear(n - 40, n)
        seg(0, 1, 0.7)                  # budget 1.25: lights bin 1
        seg(20, 3, 0.5)
        seg(n - 1, 1, 0.4, 9.0)         # lights n - 10 ... n - 2
    elif name == "long-gap":
        clear(300, 1100)
        seg(300, 280, 0.6)              # budgets 71: 64 bins lit on each
        seg(780, 280, 0.4)              # side of a gap of 200
    elif name == "gain-zero":
        clear(400, 700)
        seg(450, 20, 0.0)               # a +inf power bin's segment
        seg(470, 10, 0.5)
        seg(520, 5, 0.3)
    elif name == "weak-budget":
        clear(1000, 1200)
        seg(1020, 8, 0.5)
        bud[1030:1036] = 2.0
        bud[1100] = 1.0
        seg(1105, 4, 0.7)
    elif name == "n512":
        clear(360, 420)
        seg(0, 2, 0.9)
        seg(370, 30, 0.5)               # across the first tile's end
    elif name == "n2944":
        clear(2660, 2720)
        seg(2670, 30, 0.5)              # across the last tile's start
        seg(n - 2, 2, 0.3)
    return lim, bud


def taper_edge_args(name: str, device="cuda") -> tuple:
    """sellim_taper's (lim, budget) for one crafted case on ``device``."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in taper_edge_case(name))


def taper_expected_paths(lim: torch.Tensor, budget: torch.Tensor,
                         tile: int) -> list:
    """Per stream, per tile of ``tile`` bins: 1 where a weak bin of the
    tile or of the 64 bins on each side has budget >= 1 (the kernel runs
    the window loop there), else 0."""
    from linrad_tpu_torch.ops import sellim as sl
    lim = lim.reshape(-1, lim.shape[-1]).cpu().numpy()
    budget = np.broadcast_to(budget.cpu().numpy(), lim.shape)
    n, h = lim.shape[1], sl.TAPER_STEPS
    return [[int(np.any((lw[max(0, t - h):t + tile + h] == 0)
                        & ~(bw[max(0, t - h):t + tile + h] < 1)))
             for t in range(0, n, tile)] for lw, bw in zip(lim, budget)]


def taper_case(dev: dict, label: str, lim: torch.Tensor,
               budget: torch.Tensor, floor: float,
               plain_device: bool = True, main: bool = False) -> dict:
    """sellim_taper on (lim, budget) of one stream or, stacked, of a
    fleet's streams under torch.func.vmap (a (n,) budget shared by them);
    the tiles' paths as the kernel reports them, against the
    precondition."""
    from linrad_tpu_torch.ops import sellim as sl
    if lim.dim() == 2:
        shared = budget.dim() == 1
        budgets = [budget] * len(lim) if shared else list(budget)
        kernel = lambda: (torch.func.vmap(
            sl.sellim_taper, in_dims=(0, None if shared else 0))(
                lim, budget),)
        plain = lambda: (torch.stack([sl._sellim_taper_reference(a, b)
                                      for a, b in zip(lim, budgets)]),)
        passes = [taper_passes(a, b) for a, b in zip(lim, budgets)]
        vmap_one_launch("sellim_taper", kernel)
    else:
        kernel = lambda: (sl.sellim_taper(lim, budget),)
        plain = lambda: (sl._sellim_taper_reference(lim, budget),)
        passes = [taper_passes(lim, budget)]
    got, paths = sl.taper_paths(lim, budget)
    paths = paths.tolist()
    if paths != taper_expected_paths(lim, budget, sl.TAPER_TILE):
        raise AssertionError(f"sellim_taper {label}: the kernel's paths "
                             f"{paths} are not the precondition's")
    if not same_bits(got, kernel()[0]):
        raise AssertionError(f"sellim_taper {label}: the launch that "
                             f"reports its paths differs")
    looped = sum(map(sum, paths))
    tiles = sum(map(len, paths))
    rep = loop_case(dev, "sellim_taper",
                    f"{label} {tuple(lim.shape)}, passes run {passes}",
                    kernel, plain, compare_taper, 12 * lim.numel(),
                    taper_ops(lim, budget), floor, 20, plain_device, main)
    rep["paths"] = {"closed form": tiles - looped, "window loop": looped}
    print(f"loops sellim_taper {label}: {tiles} tiles of {sl.TAPER_TILE} "
          f"bins, {tiles - looped} in closed form, {looped} by the window "
          f"loop", flush=True)
    return rep


def phase_taper(dev: dict, floor: float | None = None,
                tapers: list | None = None) -> dict:
    """sellim_taper's cases of phase 3b: the flagship's arguments (those
    recorded from eager flagship steps, made here where not given), the
    carriers at each preset's fft1 size, past 32,768 bins, the crafted
    cases and a fleet's streams under vmap."""
    from linrad_tpu_torch import RxMode, derive_geometry, flagship_params
    from linrad_tpu_torch import preset
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.ops import sellim as sl
    from linrad_tpu_torch.utils import cuda_build
    from linrad_tpu_torch.utils.timing import graph_ms
    t0 = time.perf_counter()
    print(f"loops sellim_taper: tiles of {sl.TAPER_TILE} bins with halos of "
          f"{sl.TAPER_STEPS} on each side, one block of "
          f"{sl.TAPER_TILE + 2 * sl.TAPER_STEPS} threads a tile and stream")
    for line in cuda_build.build("sellim_taper")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"loops sellim_taper ptxas: {line.strip()}")
    if floor is None:
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    if tapers is None:
        p = flagship_params(fft1_variant="pallas")
        steps = LOOP_STREAMS + 1
        tapers = loop_args(p, make_input(derive_geometry(p), seed=6,
                                         steps=steps), TUNE_HZ, steps)[1]
    taper_rep = {"flagship": taper_case(dev, "flagship", *tapers[1],
                                        floor, main=True)}
    inputs = {}
    for mode in TAPER_MODES:
        pt = flagship_params() if mode is None else preset(RxMode[mode])
        gt = derive_geometry(pt)
        n = gt.fft1_size
        spec = torch.from_numpy(taper_spectrum(n, n)).cuda()
        args = []
        plain_updates(lambda: args.extend(record_calls(
            sl, "sellim_taper", lambda: sl.update_liminfo(
                gt, sl.SellimState.create(gt, "cuda"), spec, 8.0,
                ston=30.0))))
        inputs[n] = args[0][:2]
        # the plain version's device time hardly depends on n (a fixed
        # count of launches): taken at the largest size only
        taper_rep[n] = taper_case(dev, f"{mode or 'flagship'} carriers",
                                  *inputs[n], floor,
                                  plain_device=mode == "QRSS")
    big = max(inputs)
    for k in (2, 4):
        taper_rep[k * big] = taper_case(
            dev, f"{k} QRSS bands side by side",
            *(torch.cat([x] * k) for x in inputs[big]), floor,
            plain_device=False)
    for name in TAPER_EDGE_CASES:
        taper_rep[f"edge {name}"] = taper_case(
            dev, f"edge {name}", *taper_edge_args(name), floor,
            plain_device=False)
    lim, budget = taper_edge_args("vmap")
    taper_rep["edge vmap shared budget"] = taper_case(
        dev, "edge vmap, one budget shared", lim, budget[0], floor,
        plain_device=False)
    paths = [r["paths"] for r in taper_rep.values()]
    if not any(p["window loop"] for p in paths) \
            or not any(p["closed form"] for p in paths):
        raise AssertionError(f"sellim_taper: the cases did not reach both "
                             f"paths: {paths}")
    taper_rep["vmap"] = taper_case(
        dev, f"vmap R={LOOP_STREAMS}",
        *(torch.stack([t[i] for t in tapers[1:]]) for i in (0, 1)), floor)
    print(f"loops sellim_taper: {len(taper_rep)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return taper_rep


# Crafted streams for blanker_clear (the stupid blanker), held against the
# plain version here on the card and, through a numpy model of the
# kernel's tiles, on the CPU (tests/test_torch_blanker_clear.py): noise at
# the floor with runs of 1-8 samples 20 to 1e5 floors high, and per case
# nothing flagged, everything flagged (one run over the whole stream),
# runs longer than two tiles, runs on the stream's first and last sample,
# runs and reaches across tile edges, runs whose maximum is exactly 4
# floors (widen off) and the next float above (on), maxima at and above
# the clamp (t = 1), a +inf and a NaN power, S not a multiple of the tile,
# three channels, the widest pulse the presets' banks give (pw 30: halos
# of 15 and 31), and a floor of 0 over a stream of zeros.
CLEAR_EDGE_CASES = ("quiet", "all-flagged", "long-run", "stream-ends",
                    "tile-edges", "at-4nf", "clamp", "inf", "ragged",
                    "three-channels", "wide-pulse", "zero-floor")
# eight of them at one limit and width, as a fleet's streams under vmap,
# each with its own floor
CLEAR_VMAP_CASES = ("quiet", "all-flagged", "long-run", "stream-ends",
                    "tile-edges", "clamp", "inf", "zero-floor")
CLEAR_EDGE_S = 4_096     # 8 tiles of the kernel's 512
CLEAR_NF = 100.0
CLEAR_LIMIT = 4.0        # the flagship's stupid_bln_limit
CLEAR_PW = 2             # the width of a flat response at fft1 2,048


def clear_edge_case(name: str) -> tuple:
    """(weak (S, C) complex64, pwr (S,) float32, noise floor, limit_amp,
    pw) of one crafted case."""
    rng = np.random.default_rng(100 + CLEAR_EDGE_CASES.index(name))
    s = CLEAR_EDGE_S + (37 if name == "ragged" else 0)
    c = 3 if name == "three-channels" else 1
    nf = 0.0 if name == "zero-floor" else CLEAR_NF
    limit = 1.5 if name == "at-4nf" else CLEAR_LIMIT
    pw = 30 if name == "wide-pulse" else CLEAR_PW
    amp = np.sqrt(CLEAR_NF / (2 * c))
    x = amp * (rng.normal(size=(s, c)) + 1j * rng.normal(size=(s, c)))
    if name == "zero-floor":
        x[:] = 0.0
    if name == "all-flagged":
        x *= 0.05
        x += np.sqrt(30 * CLEAR_NF / c) * np.exp(
            2j * np.pi * rng.random((s, c)))

    def run(lo: int, n: int, peak: float) -> None:
        """n samples from lo, peak floors high in the middle."""
        lo = max(lo, 0)
        n = min(n, s - lo)
        level = peak * np.minimum(1.0, 0.2 + np.arange(n) / max(n, 1)
                                  + 0.5 * (np.arange(n) == n // 2))
        x[lo:lo + n] = np.sqrt(level * CLEAR_NF / c)[:, None] * np.exp(
            2j * np.pi * rng.random((n, c)))

    if name not in ("quiet", "all-flagged"):
        for _ in range(12):
            run(int(rng.integers(0, s - 8)), int(rng.integers(1, 9)),
                float(10 ** rng.uniform(1.3, 5)))
    if name == "long-run":
        # runs over tiles 1 to 4 and 5 to 7 whose maxima (t = 1) lie two
        # tiles from their ends, which they widen
        run(700, 1400, 300.0)
        run(1900, 1, 1e5)
        run(3000, 600, 50.0)
        run(3010, 1, 1e5)
    elif name == "stream-ends":
        run(0, 3, 1e4)
        run(s - 2, 2, 1e5)
    elif name in ("tile-edges", "wide-pulse"):
        run(505, 7, 2e3)                # ends on 511
        run(512, 3, 5e3)                # starts on 512
        run(1023, 1, 1e5)
        run(1025, 1, 1e5)
        run(1535, 2, 900.0)
        run(2048, 512, 40.0)            # exactly one tile
        run(3583, 2, 1e4)
    weak = x.astype(np.complex64)
    pwr = (np.abs(weak) ** 2).sum(1).astype(np.float32)
    nf32 = np.float32(nf)
    if name == "at-4nf":
        for lo, peak in ((400, 4 * nf32), (900, np.nextafter(4 * nf32,
                                                             np.inf)),
                         (1400, 4 * nf32), (2600, np.nextafter(4 * nf32,
                                                               np.inf))):
            pwr[lo:lo + 5] = np.float32(3 * nf32)
            pwr[lo + 2] = peak
    elif name == "clamp":
        for lo, peak in ((300, 1e4), (800, np.nextafter(np.float32(1e4),
                                                        np.float32(0))),
                         (1300, np.nextafter(np.float32(1e4), np.inf)),
                         (1800, 1e6), (2300, 3e36)):
            pwr[lo:lo + 3] = np.float32(peak) * nf32
    elif name == "inf":
        pwr[1000:1004] = np.float32(50 * nf32)
        pwr[1002] = np.inf
        pwr[2000] = np.nan
        pwr[2001] = np.float32(1e3 * nf32)
        pwr[3000] = np.nan
    return weak, pwr, nf32, limit, pw


def clear_edge_args(name: str, device="cuda") -> tuple:
    """blanker_clear's arguments for one crafted case on ``device``."""
    weak, pwr, nf, limit, pw = clear_edge_case(name)
    return (torch.from_numpy(weak).to(device),
            torch.from_numpy(pwr).to(device),
            torch.tensor(nf, dtype=torch.float32, device=device), limit, pw)


def clear_vmap_args(device="cuda") -> tuple:
    """CLEAR_VMAP_CASES stacked as R streams, each with its own floor
    (the first seven floors scaled by 1, 1.1, ...): (weak (R, S, 1), pwr
    (R, S), floors (R,), limit_amp, pw)."""
    cases = [clear_edge_args(n, device) for n in CLEAR_VMAP_CASES]
    floors = torch.stack([a[2] * (1 + 0.1 * i) if a[2] > 0 else a[2]
                          for i, a in enumerate(cases)])
    return (torch.stack([a[0] for a in cases]),
            torch.stack([a[1] for a in cases]), floors, CLEAR_LIMIT,
            CLEAR_PW)


def clear_bytes(weak: torch.Tensor) -> int:
    """What blanker_clear must move: weak and pwr read and written once,
    the floor read and the count written, per stream."""
    s, c = weak.shape[-2:]
    r = weak.numel() // (s * c)
    return r * (16 * s * c + 8 * s + 8)


def compare_clear(got, want) -> tuple[float, str]:
    """The kernel's (weak', pwr', count) against the plain version's: the
    same bits, or it raises."""
    names = ("weak", "pwr", "count")
    for n, a, b in zip(names, got, want):
        if not same_bits(a, b):
            raise AssertionError(f"blanker_clear: {n} differs from the "
                                 f"plain version's bits")
    return 0.0, (f"weak, pwr and count {got[2].tolist()} bit-equal to the "
                 f"plain version")


def clear_case(dev: dict, label: str, args: tuple, floor: float,
               plain_device: bool = True, main: bool = False) -> dict:
    """blanker_clear on (weak, pwr, floor, limit_amp, pw) of one stream
    or, stacked, of R streams under torch.func.vmap (each its own floor):
    bit for bit against its plain version, timed beside it."""
    from linrad_tpu_torch.ops import blanker as bl
    weak, pwr, nf, limit, pw = args
    before = [x.clone() for x in (weak, pwr, nf)]
    if weak.dim() == 3:
        kernel = lambda: torch.func.vmap(
            bl.blanker_clear, in_dims=(0, 0, 0, None, None))(
                weak, pwr, nf, limit, pw)
        plain = lambda: tuple(torch.stack(v) for v in zip(*(
            bl._blanker_clear_reference(weak[i], pwr[i], nf[i], limit, pw)
            for i in range(len(weak)))))
        vmap_one_launch("blanker_clear", kernel, lambda: [
            bl.blanker_clear(weak[i], pwr[i], nf[i], limit, pw)
            for i in range(len(weak))])
    else:
        kernel = lambda: bl.blanker_clear(weak, pwr, nf, limit, pw)
        plain = lambda: bl._blanker_clear_reference(weak, pwr, nf, limit,
                                                    pw)
    rep = loop_case(dev, "blanker_clear",
                    f"{label} {tuple(weak.shape)}, pw {pw}, limit {limit}",
                    kernel, plain, compare_clear, clear_bytes(weak), 0,
                    floor, 20, plain_device, main)
    if not all(same_bits(a, b) for a, b in zip((weak, pwr, nf), before)):
        raise AssertionError("blanker_clear changed an argument")
    return rep


def phase_clear(dev: dict, floor: float | None = None,
                clears: list | None = None) -> dict:
    """blanker_clear's cases of phase 3b: the arguments recorded from
    eager flagship steps (made here where not given) and EME steps, the
    crafted cases, and vmap over 8 flagship streams and over the crafted
    streams, each stream with its own floor."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops import blanker as bl
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.utils import cuda_build
    from linrad_tpu_torch.utils.timing import graph_ms
    t0 = time.perf_counter()
    print(f"loops blanker_clear: tiles of {bl.CLEAR_TILE} samples, halos "
          f"of clear_reach(pw) = {bl.clear_reach(CLEAR_PW)} at pw "
          f"{CLEAR_PW}, two launches a call")
    for line in cuda_build.build("blanker_clear")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"loops blanker_clear ptxas: {line.strip()}")
    if floor is None:
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    if clears is None:
        p = flagship_params(fft1_variant="pallas")
        steps = LOOP_STREAMS + 1
        clears = loop_args(p, make_input(derive_geometry(p), seed=6,
                                         steps=steps), TUNE_HZ, steps)[2]
    rep = {"flagship": clear_case(dev, "flagship", clears[1], floor,
                                  main=True)}
    pe = eme_params("pallas")
    eme = loop_args(pe, make_eme_input(derive_geometry(pe), 3),
                    EME_TUNE_HZ, 3)[2]
    rep["eme"] = clear_case(dev, "EME", eme[-1], floor)
    for name in CLEAR_EDGE_CASES:
        rep[f"edge {name}"] = clear_case(dev, f"edge {name}",
                                         clear_edge_args(name), floor,
                                         plain_device=False)
    rep["edge vmap"] = clear_case(dev, f"edge vmap R={len(CLEAR_VMAP_CASES)}",
                                  clear_vmap_args(), floor,
                                  plain_device=False)
    streams = clears[1:LOOP_STREAMS + 1]
    rep["vmap"] = clear_case(dev, f"vmap R={LOOP_STREAMS}", (
        torch.stack([a[0] for a in streams]),
        torch.stack([a[1] for a in streams]),
        torch.stack([a[2] for a in streams]), *streams[0][3:]), floor)
    print(f"loops blanker_clear: {len(rep)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rep


# Crafted frames for frame_pulse_stats (the radar front's statistics), held
# against the plain version on the card (phase 3b,
# tests/test_torch_radar_stats.py -m card) and, through a numpy model of
# the kernel's ballot walks, on the CPU: noise in [0, 1) under what each
# case adds: a spike a frame; Gaussian skirts 0.7-6 bins wide, on the
# row's first two and last two bins among them; skirts that fall
# linearly for 1-70 bins each side, then a bin above their end stops the
# walk (31, 32, 33, 63, 64 and 65 steps across the ballots' 32); a skirt
# over the whole row, longer than any walk; ties of the maximum (two and
# four bins, two neighbours, a constant row); peaks on bins 0, 1, n - 2
# and n - 1.  Each case at every n of STATS_NS (2,050: rows whose starts
# are not 16-byte aligned), every frame count and every walk bound.
STATS_CASES = ("noise", "spike", "skirts", "ramps", "long-skirt", "ties",
               "edges")
STATS_NS = (256, 2048, 2050, 4096)
STATS_FRAMES = (1, 64, 200)
STATS_WALKS = (0, 1, 4, 31, 32, 33, 64)
STATS_RAMPS = (1, 2, 30, 31, 32, 33, 34, 62, 63, 64, 65, 70)
STATS_TOL = 1e-5         # floor and S/N: the largest relative gap


def stats_case(name: str, frames: int, n: int) -> np.ndarray:
    """(frames, n) float32 power of one crafted case of STATS_CASES."""
    rng = np.random.default_rng(
        (STATS_CASES.index(name), frames, n))
    pw = rng.random((frames, n)).astype(np.float32)
    bins = np.arange(n)

    def skirt(c, w):
        return (1e4 * np.exp(-0.5 * ((bins - c) / w) ** 2)).astype(
            np.float32)

    for f, row in enumerate(pw):
        if name == "spike":
            row[rng.integers(n)] = 5000.0
        elif name == "skirts":
            c = (0, 1, n - 1, n - 2, 60, n // 2, n - 40, 30)[f] if f < 8 \
                else rng.integers(n)
            row += skirt(c, (3.0, 2.0, 4.0, 1.5, 6.0, 5.0, 0.7, 4.5)[f % 8])
        elif name == "ramps":
            c = rng.integers(72, n - 72)
            for side, length in zip((-1, 1), rng.choice(STATS_RAMPS, 2)):
                row[c] = 1000.0
                d = np.arange(1, length + 1)
                row[c + side * d] = 1000.0 - 10.0 * d
                row[c + side * (length + 1)] = 1000.0 - 10.0 * length + 5.0
        elif name == "long-skirt":
            c = n // 2 + f % 16 - 8
            row[:] = 0.001 * row + (n - np.abs(bins - c))
        elif name == "ties":
            kind = f % 4
            if kind == 0:
                row[rng.choice(n, 2, replace=False)] = 5.0
            elif kind == 1:
                c = rng.integers(n - 1)
                row[c:c + 2] = 5.0
            elif kind == 2:
                row[rng.choice(n, 4, replace=False)] = 5.0
            else:
                row[:] = 1.0
        elif name == "edges":
            row += skirt((0, 1, n - 2, n - 1)[f % 4], 3.0)
    return pw


def stats_walk_ends(pw: np.ndarray, k: np.ndarray, walk_steps: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(ia, ib) of each frame: radar.c's two walks from the peak bins k,
    each bounded at walk_steps, in numpy."""
    f, n = pw.shape
    rows = np.arange(f)

    def walk(d):
        idx = k.copy()
        for _ in range(min(walk_steps, n)):
            nxt, nxt2 = idx + d, idx + 2 * d
            cur = pw[rows, idx]
            step = ((nxt2 >= 0) & (nxt2 <= n - 1)
                    & (cur > pw[rows, np.clip(nxt, 0, n - 1)])
                    & (cur > pw[rows, np.clip(nxt2, 0, n - 1)]))
            idx = np.where(step, nxt, idx)
        return idx

    return walk(-1), walk(1) + 1


def stats_floor64(pw: np.ndarray, ia: np.ndarray, ib: np.ndarray
                  ) -> np.ndarray:
    """Each frame's mean power outside [ia, ib), in float64."""
    n = pw.shape[1]
    bins = np.arange(n)[None, :]
    outside = (bins < ia[:, None]) | (bins >= ib[:, None])
    t1 = np.where(outside, pw.astype(np.float64), 0.0).sum(1)
    return t1 / np.maximum(n - (ib - ia), 1)


def rel_gap(a, b) -> float:
    """max |a - b| / |b| over the elements, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def stats_gaps(power: torch.Tensor, walk_steps: int, got, want) -> dict:
    """The kernel's (k, ston, floor) of power (frames, n) or (R, frames,
    n) against the plain version's: the peak bins the same, the floor and
    the S/N within STATS_TOL, and the floor within STATS_TOL of the mean
    outside the walks' ends recomputed in float64 (a walk one bin off
    moves it further on these frames), or it raises.  Returns the
    largest relative gaps and the floor's largest absolute one."""
    n = power.shape[-1]
    pw = power.reshape(-1, n).cpu().numpy()
    k, ston, nf = (t.reshape(-1).cpu().numpy() for t in got)
    wk, wston, wnf = (t.reshape(-1).cpu().numpy() for t in want)
    if got[0].dtype != torch.int64 or not np.array_equal(k, wk):
        raise AssertionError(f"frame_pulse_stats: peak bins differ from the "
                             f"plain version's in "
                             f"{int(np.sum(k != wk))} frames")
    floor64 = stats_floor64(pw, *stats_walk_ends(pw, k, walk_steps))
    gaps = {"floor": rel_gap(nf, wnf), "ston": rel_gap(ston, wston),
            "floor64": rel_gap(nf, floor64)}
    if not max(gaps.values()) <= STATS_TOL:
        raise AssertionError(f"frame_pulse_stats at walk_steps {walk_steps}"
                             f": {gaps} over {STATS_TOL}")
    return {**gaps, "abs": float(np.max(np.abs(nf - wnf)))}


def check_stats(power: torch.Tensor, walk_steps: int, got, want
                ) -> tuple[float, str]:
    """:func:`stats_gaps` as phase 3b's compare: (max_abs_err, text)."""
    gaps = stats_gaps(power, walk_steps, got, want)
    return gaps["abs"], (
        "peak bins equal to the plain version's, floor / S/N / floor "
        "against float64 from the walk ends: " + ", ".join(
            f"{gaps[g]:.2e}" for g in ("floor", "ston", "floor64")))


def stats_case_run(dev: dict, label: str, power: torch.Tensor,
                   walk_steps: int, floor: float, main: bool = False
                   ) -> dict:
    """frame_pulse_stats on power (frames, n), or (R, frames, n) under
    torch.func.vmap (one launch, bit-equal to R calls), against its plain
    version on the card, timed beside it."""
    from linrad_tpu_torch.weak import radar as rd
    if power.dim() == 3:
        kernel = lambda: torch.func.vmap(
            rd.frame_pulse_stats, in_dims=(0, None))(power, walk_steps)
        plain = lambda: tuple(torch.stack(v) for v in zip(*(
            rd._frame_pulse_stats_reference(p, walk_steps) for p in power)))
        vmap_one_launch("radar_stats", kernel, lambda: [
            rd.frame_pulse_stats(p, walk_steps) for p in power])
    else:
        kernel = lambda: rd.frame_pulse_stats(power, walk_steps)
        plain = lambda: rd._frame_pulse_stats_reference(power, walk_steps)
    rows = power.numel() // power.shape[-1]
    return loop_case(dev, "radar_stats", f"{label} {tuple(power.shape)}, "
                     f"walk_steps {walk_steps}", kernel, plain,
                     lambda got, want: check_stats(power, walk_steps, got,
                                                   want),
                     4 * power.numel() + 16 * rows, 0, floor, 20, True, main)


def phase_stats(dev: dict, floor: float | None = None) -> dict:
    """radar_stats' cases of phase 3b: the radar front's power of
    preset(RADAR) steps (phase 23's pulse train), timed beside the plain
    version; every crafted case at every n, frame count and walk bound;
    vmap over 8 of the front's steps."""
    from linrad_tpu_torch import RxMode, derive_geometry, preset
    from linrad_tpu_torch.io.modeinput import radar_iq
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.utils import cuda_build
    from linrad_tpu_torch.utils.timing import graph_ms
    from linrad_tpu_torch.weak import radar as rd
    t0 = time.perf_counter()
    for line in cuda_build.build("radar_stats")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"loops radar_stats ptxas: {line.strip()}")
    if floor is None:
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    p = preset(RxMode.RADAR, fft1_variant="pallas")
    geo = derive_geometry(p)
    steps = LOOP_STREAMS + 1
    iq = radar_iq(geo, steps, tx_bin=RADAR_TX_BIN, pulse_sep=RADAR_SEP,
                  pulse_width=RADAR_WIDTH, echo_delay=RADAR_DELAY,
                  doppler_bins=RADAR_DOPPLER)[:, None]
    powers = [o[0] for o in radar_mode_fronts(p, iq, steps, "cuda",
                                              False)[2]]
    rep = {"radar": stats_case_run(dev, "radar front", powers[1], 32,
                                   floor, main=True)}
    for walk in (0, 64):
        rep[f"radar walk {walk}"] = stats_case_run(
            dev, "radar front", powers[1], walk, floor)
    for name in STATS_CASES:
        worst = {}
        for n in STATS_NS:
            for frames in STATS_FRAMES:
                power = torch.from_numpy(stats_case(name, frames, n)).cuda()
                for walk in STATS_WALKS:
                    got = rd.frame_pulse_stats(power, walk)
                    want = rd._frame_pulse_stats_reference(power, walk)
                    for g, v in stats_gaps(power, walk, got, want).items():
                        worst[g] = max(worst.get(g, 0.0), v)
        rep[f"edge {name}"] = worst
        print(f"loops radar_stats edge {name}: n {STATS_NS} x frames "
              f"{STATS_FRAMES} x walk_steps {STATS_WALKS}: peak bins equal, "
              f"walk ends pinned; largest relative gaps floor "
              f"{worst['floor']:.2e}, S/N {worst['ston']:.2e}, floor "
              f"against float64 {worst['floor64']:.2e} (bar {STATS_TOL}); "
              f"floor max_abs_err {worst['abs']:.3e}", flush=True)
    rep["vmap"] = stats_case_run(dev, f"vmap R={LOOP_STREAMS}",
                                 torch.stack(powers[1:]), 32, floor)
    print(f"loops radar_stats: {len(rep)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rep


# Crafted liminfo updates for sellim_update (update_liminfo's two kernels
# around the taper), held against the plain version here on the card and,
# through a numpy model of the kernels, on the CPU
# (tests/test_torch_sellim_update.py): chi-square noise around a power of
# 1,000 with carriers of 1e9 to 1e12 over a limit of 1e8 (in band order:
# bin n/2 first for IQ), and per case no strong bin, one strong bin, strong
# runs on the band's first and last bins and across the IQ roll's seam
# (DC bin 0), a +inf power bin and a limit of 0 (maxlevel 0: every bin
# strong at gain 0; both the taper's window loop), a passband over a
# segment, an old state of gains, carriers and counters (smoothing, the
# release cap, counters counting down), NaN power, real input (no roll),
# ties of power, runs and skirts longer than a thread's chunk, every bin
# strong, 20 groups (the floor's sums over lanes holding two means), and n
# 4,096, 8,192, 16,384 and 32,768 (the band station's fft1).
UPDATE_EDGE_CASES = ("quiet", "one-strong", "band-edges", "inf",
                     "maxlevel-0", "passband", "history", "nan", "real",
                     "ties", "long-runs", "all-strong", "groups-20",
                     "n4096", "n8192", "n16384", "n32768")
UPDATE_LIMIT = 1e8
UPDATE_WAIT_N = 7
# eight of them at n 2,048 as a fleet's streams under vmap
UPDATE_VMAP_CASES = ("quiet", "one-strong", "band-edges", "inf",
                     "passband", "history", "nan", "ties")


def update_edge_case(name: str) -> dict:
    """One crafted update: ``p`` (n,) float32 power, ``lim`` and ``wait``
    the old state (DC-at-0 order), ``sel`` (lo, hi) or None, and the
    operator's constants ``limit``, ``ston``, ``half``, ``wait_n`` and
    ``groups``."""
    rng = np.random.default_rng(300 + UPDATE_EDGE_CASES.index(name))
    n = {"groups-20": 2560, "n4096": 4096, "n8192": 8192,
         "n16384": 16384, "n32768": 32768}.get(name, 2048)
    half = 0 if name == "real" else n // 2
    k = np.arange(n)
    band = 1e3 * rng.chisquare(4, size=n) / 4

    def carrier(centre: float, height: float, width: float) -> None:
        band[:] += height * np.exp(-0.5 * ((k - centre) / width) ** 2)

    if name not in ("quiet", "one-strong"):
        for _ in range(n // 400):
            carrier(rng.uniform(10, n - 10), 10 ** rng.uniform(9, 12),
                    rng.uniform(0.5, 3.0))
    lim = np.zeros(n, np.float32)
    wait = np.zeros(n, np.int32)
    sel, limit, groups = None, UPDATE_LIMIT, 32
    if name == "one-strong":
        band[777] = 1e10
        sel = (100, 120)
    elif name == "band-edges":
        band[:4] += 5e10
        band[-4:] += 3e11
        carrier(n // 2, 1e12, 2.0)      # DC bin 0 at its centre for IQ
        carrier(n // 2 + 40.5, 2e9, 0.6)
    elif name == "inf":
        centre = int(rng.integers(200, n - 200))
        carrier(centre, 1e11, 1.5)
        band[centre] = np.inf
    elif name == "maxlevel-0":
        limit = 0.0
    elif name == "passband":
        carrier(1000, 1e11, 2.0)
        sel = ((1000 - 6 - half) % n, (1000 + 6 - half) % n)
    elif name == "history":
        u = rng.uniform(size=n)
        lim = np.where(u < 0.2, -1.0, np.where(
            u < 0.5, 10 ** rng.uniform(-2.5, 0.5, size=n), 0.0))
        lim = lim.astype(np.float32)
        wait = rng.integers(0, 40, size=n).astype(np.int32)
        for centre in (300.0, 1300.0):   # old gains near the new ones
            carrier(centre, 1e11, 2.0)
            lim[(int(centre) - 8 - half) % n:(int(centre) + 8 - half) % n] \
                = 0.03
        sel = (1500, 1530)
    elif name == "nan":
        band[50] = np.nan
        centre = int(rng.integers(200, n - 200))
        carrier(centre, 1e11, 2.0)
        band[centre + 2] = np.nan
    elif name == "real":
        band[1] += 1e11
        band[n - 2] += 1e11
    elif name == "ties":
        band = np.round(band / 500.0) * 500.0 + 500.0
        band[300:340] = 5e10
        band[900:902] = 2e10
    elif name == "long-runs":
        carrier(700, 1e12, 120.0)
        carrier(1500, 1e11, 40.0)
    elif name == "all-strong":
        limit = 1e-3
    elif name == "groups-20":
        groups = 20
    p = np.roll(band, -half).astype(np.float32)
    return {"p": p, "lim": lim, "wait": wait, "sel": sel,
            "limit": float(np.float32(limit)), "ston": 30.0, "half": half,
            "wait_n": UPDATE_WAIT_N, "groups": groups}


def update_edge_args(name: str, device="cuda") -> tuple:
    """sellim_update's arguments for one crafted case on ``device``."""
    c = update_edge_case(name)
    sel = (None, None) if c["sel"] is None else tuple(
        torch.tensor(v, dtype=torch.int64, device=device) for v in c["sel"])
    return (torch.from_numpy(c["p"]).to(device),
            torch.from_numpy(c["lim"]).to(device),
            torch.from_numpy(c["wait"]).to(device), *sel, c["limit"],
            c["ston"], c["half"], c["wait_n"], c["groups"])


def card_floor_thr(args: tuple) -> torch.Tensor:
    """The plain version's carrier threshold for sellim_update's
    arguments, by its own operations (step 5) on the args' device."""
    p, *_rest = args
    *_, ston, half, _wait_n, groups = args
    p = torch.roll(torch.clamp(p, min=1e-30), half)
    n = p.shape[0]
    small3 = torch.topk(p.reshape(groups, n // groups), 3, dim=1,
                        largest=False, sorted=True).values
    gmin = small3.mean(1)
    sel = gmin < 2.0 * gmin.mean()
    floor = (torch.where(sel, gmin, 0.0).sum()
             / torch.clamp(sel.sum(), min=1))
    return floor * ston


def cuda_row_sum(g: np.ndarray) -> np.float32:
    """PyTorch's CUDA sum of a row of G <= 32 float32 values, as the front
    kernel takes it: lane x of bw = 2^floor(log2 G) holds x and x + bw,
    then shfl_down at offsets bw/2, ..., 1."""
    f32 = np.float32
    bw = 1 << (len(g).bit_length() - 1)
    v = [f32(0) + f32(g[x]) for x in range(bw)]
    for x in range(len(g) - bw):
        v[x] = f32(v[x] + f32(g[x + bw]))
    while len(v) > 1:
        h = len(v) // 2
        v = [f32(v[x] + v[x + h]) for x in range(h)]
    return v[0]


def mean_order_probe(dev: dict) -> None:
    """The front kernel's premise: PyTorch's CUDA sum and mean of a
    float32 row of 3, 20 and 32 take ``cuda_row_sum``'s order, the mean
    then times the float of rows / elements.  Random rows, each held."""
    rng = np.random.default_rng(12)
    seen = []
    for g in (3, 20, 32):
        x = (rng.uniform(1.0, 2.0, size=(256, g))
             * 2.0 ** rng.integers(-12, 12, size=(256, g))).astype(np.float32)
        t = torch.from_numpy(x).cuda()
        want = np.array([cuda_row_sum(r) for r in x], np.float32)
        rows = np.float32(256) / np.float32(256 * g)
        same = (int((t.sum(1).cpu().numpy() == want).sum()),
                int((t.mean(1).cpu().numpy() == want * rows).sum()),
                int((torch.stack([r.clone().sum() for r in t]).cpu().numpy()
                     == want).sum()))
        seen.append(f"rows of {g}: row sums {same[0]}, row means {same[1]}, "
                    f"sums of one row {same[2]} of 256")
        if min(same) < 256:
            raise AssertionError(f"sellim_update: PyTorch's CUDA reduction "
                                 f"of rows of {g} is not the front kernel's "
                                 f"order: {same}")
    print(f"loops sellim_update probe: PyTorch's CUDA sums and means in the "
          f"front kernel's order: " + "; ".join(seen) + f" [{dev['smi']}]",
          flush=True)


def compare_update(got, want) -> tuple[float, str]:
    """sellim_update's (liminfo, liminfo_wait) against the plain version's:
    bit for bit."""
    (kl, kw), (rl, rw) = got, want
    if not torch.equal(kw, rw):
        raise AssertionError(f"sellim_update: liminfo_wait differs in "
                             f"{int((kw != rw).sum())} bins")
    if not torch.equal(torch.sign(kl), torch.sign(rl)):
        raise AssertionError(f"sellim_update: the sign pattern differs in "
                             f"{int((torch.sign(kl) != torch.sign(rl)).sum())}"
                             f" bins")
    if not same_bits(kl, rl):
        raise AssertionError(f"sellim_update: liminfo not bit-equal, "
                             f"max_rel {max_rel(kl, rl):.3e}")
    return 0.0, (f"liminfo and liminfo_wait bit-equal, "
                 f"{int((kl > 0).sum())} limited, "
                 f"{int((kl < 0).sum())} to the strong channel")


def update_case(dev: dict, label: str, args: tuple, floor: float,
                plain_device: bool = True, main: bool = False,
                in_dims: tuple | None = None) -> dict:
    """sellim_update on one stream's arguments, or on R streams' stacked
    under torch.func.vmap (``in_dims``: 0 for a stacked argument, None for
    one that serves every stream): against the plain version on the card,
    with the front kernel's taper arguments and threshold beside the plain
    version's; under vmap one launch of each kernel."""
    from linrad_tpu_torch.ops import sellim as sl
    const = args[5:]
    if in_dims is None:
        kernel = lambda: sl.sellim_update(*args)
        streams = [args]
    else:
        kernel = lambda: torch.func.vmap(sl.sellim_update,
                                         in_dims=in_dims)(*args)
        r = args[0].shape[0]
        streams = [tuple(a if d is None else a[j]
                         for a, d in zip(args, in_dims)) for j in range(r)]
        counts = (sl.update_count.launches, sl.taper_count.launches)
        each = [sl.sellim_update(*a) for a in streams]
        got = kernel()
        if (sl.update_count.launches - counts[0] != 2 * len(streams) + 2
                or sl.taper_count.launches - counts[1]
                != len(streams) + 1):
            raise AssertionError(f"sellim_update {label}: under vmap not "
                                 f"one launch of each kernel")
        if not all(same_bits(torch.stack(v), g)
                   for v, g in zip(zip(*each), got)):
            raise AssertionError(f"sellim_update {label}: vmap differs from "
                                 f"separate calls")

    def plain():
        outs = [sl._update_liminfo_reference(*a) for a in streams]
        return tuple(torch.stack(v) for v in zip(*outs)) \
            if in_dims is not None else outs[0]

    # the front kernel's taper arguments and threshold against the plain
    # version's, per stream
    gaps = []
    for a in streams:
        scratch = {}
        sl._update_launch(*(x[None] for x in a[:3]), *a[3:5], *const,
                          scratch=scratch)
        taper = []
        plain_updates(lambda: taper.extend(record_calls(
            sl, "sellim_taper", lambda: sl.sellim_update(*a))))
        (lim0, bud0), = taper
        if not (same_bits(scratch["lim"][0], lim0)
                and same_bits(scratch["budget"][0], bud0)):
            raise AssertionError(f"sellim_update {label}: the front "
                                 f"kernel's taper arguments differ from the "
                                 f"plain version's")
        thr, want = scratch["thr"][0], card_floor_thr(a)
        gaps.append(abs(thr.item() - want.item()) / abs(want.item())
                    if want.item() else abs(thr.item()))
    n = args[0].shape[-1]
    nbytes = 20 * n * len(streams)
    rep = loop_case(dev, "sellim_update",
                    f"{label} {tuple(args[0].shape)}", kernel, plain,
                    compare_update, nbytes, 0, floor, 20, plain_device, main)
    rep["thr_gap"] = max(gaps)
    print(f"loops sellim_update {label}: the front kernel's taper arguments "
          f"bit-equal to the plain version's; carrier threshold against the "
          f"plain version's on the card: largest relative gap "
          f"{max(gaps):.3e}", flush=True)
    return rep


def phase_sellim(dev: dict, floor: float | None = None,
                 updates: list | None = None) -> dict:
    """sellim_update's cases of phase 3b: the arguments of eager flagship
    steps (made here where not given) and of EME steps, the crafted cases,
    and vmap over 8 flagship streams and over 8 crafted ones (a passband
    each, then one shared)."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.utils import cuda_build
    from linrad_tpu_torch.utils.timing import graph_ms
    t0 = time.perf_counter()
    for line in cuda_build.build("sellim_update")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"loops sellim_update ptxas: {line.strip()}")
    mean_order_probe(dev)
    if floor is None:
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    if updates is None:
        p = flagship_params(fft1_variant="pallas")
        steps = LOOP_STREAMS + 1
        updates = loop_args(p, make_input(derive_geometry(p), seed=6,
                                          steps=steps), TUNE_HZ, steps)[3]
    rep = {"flagship": update_case(dev, "flagship", updates[1], floor,
                                   main=True)}
    pe = eme_params("pallas")
    eme = loop_args(pe, make_eme_input(derive_geometry(pe), 3),
                    EME_TUNE_HZ, 3)[3]
    rep["eme"] = update_case(dev, "EME", eme[-1], floor)
    for name in UPDATE_EDGE_CASES:
        rep[f"edge {name}"] = update_case(dev, f"edge {name}",
                                          update_edge_args(name), floor,
                                          plain_device=False)
    streams = updates[1:LOOP_STREAMS + 1]
    stacked = tuple(torch.stack([a[i] for a in streams]) for i in range(5))
    rep["vmap"] = update_case(dev, f"vmap R={LOOP_STREAMS}",
                              stacked + streams[0][5:], floor,
                              in_dims=(0,) * 5 + (None,) * 5)
    crafted = [update_edge_args(c) for c in UPDATE_VMAP_CASES]
    lo = torch.tensor(1500, dtype=torch.int64, device="cuda")
    edge = tuple(torch.stack([c[i] for c in crafted]) for i in range(3))
    each_sel = tuple(torch.stack([
        c[i] if c[i] is not None else lo + 3 * (i - 3) for c in crafted])
        for i in (3, 4))
    rep["edge vmap"] = update_case(
        dev, f"edge vmap R={len(crafted)}", edge + each_sel
        + crafted[0][5:], floor, plain_device=False,
        in_dims=(0,) * 5 + (None,) * 5)
    rep["edge vmap shared passband"] = update_case(
        dev, f"edge vmap R={len(crafted)}, one passband", edge
        + (lo, lo + 9) + crafted[0][5:], floor, plain_device=False,
        in_dims=(0,) * 3 + (None,) * 7)
    print(f"loops sellim_update: {len(rep)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rep


# Crafted fractional-bin ramps for mix1_ramp (mix1's ramp kernel), held
# against the plain version here on the card and, through a numpy model of
# the kernel, on the CPU (tests/test_torch_mix1_ramp.py): each row length
# of RAMP_SHAPES as frames x hop (one sample; a block of 16 short of one,
# one, one past; the sums' levels at 255 and 256; the cells' 4,096 and
# one past; 65,536), with 1, 8 and 24 rows, one fraction a row or one a
# frame, with and without a slope.  Fractions of either sign up to half a
# bin, phases in [0, 1), slopes up to 0.05 bins a hop; among the rows of
# 8 and 24 a fraction of -0.0 on a phase of 0 (the zeros' signs) and
# fractions of exactly +-0.5.
RAMP_SHAPES = {1: (1, 1), 15: (5, 3), 16: (2, 8), 17: (17, 1),
               255: (15, 17), 256: (2, 128), 4096: (32, 128),
               4097: (17, 241), 65536: (64, 1024)}
RAMP_ROWS = (1, 8, 24)
RAMP_CASES = tuple((length, rows, per_frame, slope)
                   for length in RAMP_SHAPES for rows in RAMP_ROWS
                   for per_frame in (False, True) for slope in (False, True))


def ramp_label(case: tuple) -> str:
    length, rows, per_frame, slope = case
    return (f"L{length}-rows{rows}-{'frames' if per_frame else 'one'}"
            f"{'-slope' if slope else ''}")


def ramp_args(case: tuple, device="cuda") -> tuple:
    """(frac_phase, tune_frac, tune_slope, n, m, hop) of one crafted case
    of RAMP_CASES: one row is a Receiver's shapes (a 0-d phase, a 0-d or
    (n,) fraction), more rows a stacked state's ((rows,), then (rows, 1) or
    (rows, n)); m the power of two at least twice hop, as the geometry's."""
    length, rows, per_frame, slope = case
    n, hop = RAMP_SHAPES[length]
    m = max(8, 1 << (2 * hop - 1).bit_length())
    rng = np.random.default_rng(RAMP_CASES.index(case))
    f32 = np.float32
    fp = rng.random(rows).astype(f32)
    fr = rng.uniform(-0.5, 0.5, (rows, n if per_frame else 1)).astype(f32)
    sl = rng.uniform(-0.05, 0.05, fr.shape).astype(f32)
    if rows > 1:
        fp[0], fr[0], fr[1], fr[2] = 0.0, -0.0, 0.5, -0.5
    if rows == 1:
        fp, fr, sl = fp[0], fr[0], sl[0]
        if not per_frame:
            fr, sl = fr[0], sl[0]
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return t(fp), t(fr), t(sl) if slope else None, n, m, hop


def compare_ramp(got, want) -> tuple[float, str]:
    """mix1_ramp's (ramp, new phase) against the plain version's: bit for
    bit."""
    (kr, kp), (rr, rp) = got, want
    if not (same_bits(kr, rr) and same_bits(kp, rp)):
        raise AssertionError(f"mix1_ramp: not bit-equal: ramp max_rel "
                             f"{max_rel(kr, rr):.3e}, phase max_rel "
                             f"{max_rel(kp, rp):.3e}")
    return 0.0, "ramp and new phase bit-equal"


def ramp_probe(dev: dict) -> None:
    """The kernel's premises: its remainder, -2 pi product, cosf and sinf
    are torch's on the card for values of every size and sign (the probe
    kernel of csrc/mix1_ramp.cu against torch.remainder(x, 1.0),
    (-2.0 * math.pi) * x, torch.cos, torch.sin), and torch's division of
    a float32 tensor by a Python integer is the product with its float
    reciprocal."""
    import ctypes
    from linrad_tpu_torch.utils import cuda_build
    rng = np.random.default_rng(24)
    f32 = np.float32
    special = np.array([0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0, 1e-30,
                        -1e-30, 1 - 2 ** -24, -(2 ** -24), 2 ** -24, 1e6,
                        -1e6, 3e7, -3e7, 0.99999994, -0.99999994], f32)
    x = np.concatenate([special] + [
        (rng.standard_normal(4096) * scale).astype(f32)
        for scale in (1e-3, 0.3, 1.0, 7.0, 1e3)])
    xt = torch.from_numpy(x).cuda()
    out = torch.empty((x.size, 4), dtype=torch.float32, device="cuda")
    cuda_build.launch(
        cuda_build.bind("mix1_ramp", "lrt_mix1_ramp_probe",
                        (ctypes.c_void_p,) * 2 + (ctypes.c_int,
                                                  ctypes.c_void_p)),
        (xt.data_ptr(), out.data_ptr(), x.size), xt.device,
        "mix1_ramp probe", None)
    want = (torch.remainder(xt, 1.0), (-2.0 * math.pi) * xt, torch.cos(xt),
            torch.sin(xt))
    same = [int((out[:, j].view(torch.int32) == w.view(torch.int32)).sum())
            for j, w in enumerate(want)]
    divs = []
    for d in (3, 15, 17, 128, 241, 256, 1024):
        inv = float(f32(1) / f32(d))
        divs.append(int((xt / d).view(torch.int32).eq(
            (xt * inv).view(torch.int32)).sum()))
    print(f"loops mix1_ramp probe: of {x.size} values the kernel's "
          f"remainder, -2 pi product, cosf and sinf equal torch's on the "
          f"card in {same}; x / d equal to x times the float of 1 / d for "
          f"d 3, 15, 17, 128, 241, 256, 1,024 in {divs} [{dev['smi']}]",
          flush=True)
    if min(same + divs) < x.size:
        raise AssertionError(f"mix1_ramp: the kernel's float operations "
                             f"are not torch's on the card: {same}, {divs}")


def ramp_case(dev: dict, label: str, args: tuple, floor: float,
              main: bool = False, in_dims: tuple | None = None) -> dict:
    """mix1_ramp on one call's arguments, or under torch.func.vmap over
    stacked streams (``in_dims``; the plain version vmapped the same way,
    as the fleet ran it): against the plain version on the card, bit for
    bit, one launch; timed beside it.  Its bound is the launch floor: the
    bytes (the fractions read, 8 a sample and the phase written) take a
    small share of it."""
    from linrad_tpu_torch.ops import mix1 as mx
    if in_dims is None:
        kernel = lambda: mx.mix1_ramp(*args)
        plain = lambda: mx._frac_ramp_reference(*args)
        before = mx.ramp_count.launches
        kernel()
        if mx.ramp_count.launches != before + 1:
            raise AssertionError(f"mix1_ramp {label}: not one launch")
    else:
        kernel = lambda: torch.func.vmap(mx.mix1_ramp, in_dims=in_dims)(
            *args)
        plain = lambda: torch.func.vmap(mx._frac_ramp_reference,
                                        in_dims=in_dims)(*args)
        vmap_one_launch("mix1_ramp", kernel)
    fp, fr, sl, n, _m, hop = args
    rows = fp.numel()
    nbytes = 4 * (fr.numel() + (0 if sl is None else sl.numel())) \
        + rows * (8 + 8 * n * hop)
    rep = loop_case(dev, "mix1_ramp", f"{label} ({rows} rows, L {n * hop})",
                    kernel, plain, compare_ramp, nbytes, 0, floor, 50,
                    main=main)
    rep["bytes_ms"], rep["bound_ms"] = rep["bound_ms"], floor
    rep["bound_by"] = "launch"
    print(f"loops mix1_ramp {label}: bound_ms {floor:.5f} (the launch "
          f"floor; its {nbytes} bytes alone {rep['bytes_ms']:.6f}), share "
          f"of bound {floor / rep['device_ms']:.3f}", flush=True)
    return rep


def plain_ramps(run):
    """run() with mix1's ramp through its plain version (frac_ramp calls
    the module's mix1_ramp)."""
    from linrad_tpu_torch.ops import mix1 as mx
    real = mx.mix1_ramp
    mx.mix1_ramp = mx._frac_ramp_reference
    try:
        return run()
    finally:
        mx.mix1_ramp = real


def ramp_calls(p, iq: np.ndarray, tune_hz: float, steps: int) -> list:
    """The arguments of every mix1_ramp call in ``steps`` eager steps of a
    Receiver of p on the card."""
    from linrad_tpu_torch.ops import mix1 as mx
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, device="cuda", graphed=False)
    rx.tune(tune_hz)
    s = rx.geo.samples_per_step
    return record_calls(mx, "mix1_ramp", lambda: [
        rx.process_block(iq[i * s:(i + 1) * s]) for i in range(steps)])


def phase_ramp(dev: dict, floor: float | None = None) -> dict:
    """mix1_ramp's cases of phase 3b: the probe; the arguments of eager
    flagship steps (one row, 4,096 samples), the 8 of them as a fleet's
    streams under vmap, the EME receiver's per-frame fractions and slopes
    once the AFC holds the signal (the slope case), timed beside the plain
    version; every crafted case bit for bit."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.ops import mix1 as mx
    from linrad_tpu_torch.utils import cuda_build
    from linrad_tpu_torch.utils.timing import graph_ms
    t0 = time.perf_counter()
    for line in cuda_build.build("mix1_ramp")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"loops mix1_ramp ptxas: {line.strip()}")
    ramp_probe(dev)
    if floor is None:
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    p = flagship_params(fft1_variant="pallas")
    steps = LOOP_STREAMS + 1
    flag = ramp_calls(p, make_input(derive_geometry(p), seed=6, steps=steps),
                      TUNE_HZ, steps)
    rep = {"flagship": ramp_case(dev, "flagship", flag[1], floor,
                                 main=True)}
    streams = flag[1:LOOP_STREAMS + 1]
    rep["vmap"] = ramp_case(
        dev, f"vmap R={LOOP_STREAMS}", (torch.stack([a[0] for a in streams]),
                                        streams[0][1], None,
                                        *streams[0][3:]), floor,
        in_dims=(0, None, None, None, None, None))
    pe = eme_params("pallas")
    eme = [a for a in ramp_calls(pe, make_eme_input(derive_geometry(pe),
                                                    EME_STEPS),
                                 EME_TUNE_HZ, EME_STEPS) if a[2] is not None]
    if not eme:
        raise AssertionError("mix1_ramp: the EME receiver never handed the "
                             "ramp a slope")
    rep["eme slope"] = ramp_case(dev, "EME per-frame fractions and slopes",
                                 eme[-1], floor)
    for case in RAMP_CASES:
        args = ramp_args(case)
        compare_ramp(mx.mix1_ramp(*args), mx._frac_ramp_reference(*args))
    print(f"loops mix1_ramp: the {len(RAMP_CASES)} crafted cases (lengths "
          f"{tuple(RAMP_SHAPES)}, rows {RAMP_ROWS}, one fraction or one a "
          f"frame, with and without a slope) bit-equal to the plain version "
          f"on the card; {len(rep)} timed cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rep


def phase_loop_kernels(dev: dict) -> dict:
    """Phase 3b.  Returns, per loop kernel, its report at the main path's
    shape (the flagship's) and at every other shape."""
    from linrad_tpu_torch import RxMode, derive_geometry, flagship_params
    from linrad_tpu_torch import preset
    from linrad_tpu_torch.io.modeinput import mode_input
    from linrad_tpu_torch.ops import fused_fft1 as ff
    from linrad_tpu_torch.utils.timing import graph_ms
    from linrad_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    for line in cuda_build.build("blanker_fits")[1]["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"loops blanker_fits ptxas: {line.strip()}")
    cuda = torch.device("cuda", torch.cuda.current_device())
    floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
    p = flagship_params(fft1_variant="pallas")
    geo = derive_geometry(p)
    steps = LOOP_STREAMS + 1
    fits, tapers, clears, updates = loop_args(p, make_input(geo, seed=6,
                                                   steps=steps),
                                     TUNE_HZ, steps)
    fits_rep = {"flagship": fits_case(dev, "flagship", fits[1], floor,
                                      main=True)}
    pe = eme_params("pallas")
    ge = derive_geometry(pe)
    eme_fits = loop_args(pe, make_eme_input(ge, 3), EME_TUNE_HZ, 3)[0]
    fits_rep["eme"] = fits_case(dev, "EME", eme_fits[-1], floor)
    pw_ = preset(RxMode.WCW)
    gw = derive_geometry(pw_)
    wcw_fits = loop_args(pw_, mode_input(RxMode.WCW, gw, 2,
                                         PRESET_DIAL_HZ),
                         PRESET_DIAL_HZ, 2)[0]
    fits_rep["wcw"] = fits_case(dev, "WCW", wcw_fits[-1], floor)
    fits_rep["vmap"] = fits_vmap_case(dev, fits[1:], floor)
    # a time shard's halos: no candidate centre there
    wpad, ppad, _c, bmax, *rest = fits[1]
    lead, s = rest[-2], rest[-1]
    active = torch.zeros(wpad.shape[0], dtype=torch.bool, device=cuda)
    active[lead + LOOP_HALO: lead + s - LOOP_HALO] = True
    candp = torch.where(active, ppad, -1.0)
    bmax = candp.reshape(bmax.shape[0], -1).amax(1)
    fits_rep["eligible"] = fits_case(dev, "eligible halo", (
        wpad, ppad, candp, bmax, *rest), floor, plain_device=False)
    for name in FITS_EDGE_CASES:
        fits_rep[f"edge {name}"] = fits_case(
            dev, f"edge {name}", fits_edge_args(name), floor,
            plain_device=False)
    fits_rep["past plan"] = fits_case(
        dev, "past the shared-memory plan", past_plan_args(fits[1:9]),
        floor, plain_device=False)
    fits_rep["past plan W"] = fits_case(
        dev, "past the shared-memory plan, wider sub-blocks",
        past_plan_args(fits[1:9], 2), floor, plain_device=False)
    plans = (fits_rep["past plan"]["plan"], fits_rep["past plan W"]["plan"])
    if plans[0]["bank_shared"] or plans[0]["sub_block"] != 32 \
            or plans[1]["bank_shared"] or plans[1]["sub_block"] == 32:
        raise AssertionError(f"the past-plan cases do not reach the bank in "
                             f"L2 and the wider sub-blocks: {plans}")

    taper_rep = phase_taper(dev, floor, tapers)
    clear_rep = phase_clear(dev, floor, clears)
    stats_rep = phase_stats(dev, floor)
    update_rep = phase_sellim(dev, floor, updates)
    ramp_rep = phase_ramp(dev, floor)
    print(f"loops: kernels against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_loop_chain(dev)
    print(f"loops: phase 3b in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"blanker_fits": fits_rep, "sellim_taper": taper_rep,
            "blanker_clear": clear_rep, "radar_stats": stats_rep,
            "sellim_update": update_rep, "mix1_ramp": ramp_rep}


def compare_batches(got: dict, ref: dict, geo, label: str) -> None:
    """Two BatchRunner results to the chain's bars: the blanker counts and
    liminfo's signs exact, audio 1e-3 in step 0 and 1e-4 after, the rest
    CHAIN_TOL or CHAIN_TOL_OTHER."""
    bb = geo.baseband_samples_per_step
    for f in ("blanker_fitted", "blanker_cleared"):
        if not np.array_equal(got[f], ref[f]):
            raise AssertionError(f"{label}: {f} {got[f].ravel().tolist()} "
                                 f"!= {ref[f].ravel().tolist()}")
    if not np.array_equal(np.sign(got["liminfo"]), np.sign(ref["liminfo"])):
        raise AssertionError(f"{label}: liminfo sign pattern differs")
    worst = {}
    for f in ("audio", "baseb", "fft2_power", "liminfo"):
        a, b = torch.from_numpy(got[f]), torch.from_numpy(ref[f])
        if f == "audio":
            worst["audio step 0"] = (max_rel(a[:bb], b[:bb]),
                                     START_AUDIO_TOL)
            a, b = a[bb:], b[bb:]
        worst[f] = (max_rel(a, b), CHAIN_TOL.get(f, CHAIN_TOL_OTHER))
    print(f"{label}: blanker counts and liminfo signs exact; " + ", ".join(
        f"{k} max_rel {v:.3e} (bar {bar})" for k, (v, bar) in worst.items()))
    bad = [k for k, (v, bar) in worst.items() if v > bar]
    if bad:
        raise AssertionError(f"{label}: {bad} outside their bars")


def lowered_fits(*args):
    """The plain fits with the reference pulse bank rounded to bfloat16:
    every subtracted pulse a little wrong."""
    from linrad_tpu_torch.ops import blanker as bl
    bank = torch.view_as_real(args[4]).bfloat16().float()
    return bl._blanker_fits_reference(*args[:4], torch.view_as_complex(bank),
                                      *args[5:])


def lowered_fit_reading(p, iq: np.ndarray, kern: list, geo) -> None:
    """What the chain's bars read for a fit that is a little wrong: the
    graphed Receiver with ``lowered_fits`` against the one through the
    kernels.  Printed, not asserted: it shows how far the bars sit from
    such a fault."""
    low = with_loop_references(lambda: run_rx(p, iq, "cuda"),
                               fits=lowered_fits)
    agc0 = max_rel(kern[0].agc_gain, low[0].agc_gain)
    try:
        compare_runs(kern, low, flagship_shapes(geo), "loops lowered fit: ",
                     start_tol=LOOP_START_TOL,
                     what="graphed Receiver with the reference bank at "
                          "bfloat16 against the loop kernels")
        verdict = "the chain's bars pass it"
    except AssertionError as e:
        verdict = f"the chain's bars fail it ({e})"
    print(f"loops lowered fit: step 0 agc_gain max_rel {agc0:.3e} (bar "
          f"{LOOP_START_TOL['agc_gain']}); {verdict}", flush=True)


def phase_loop_chain(dev: dict) -> None:
    """The graphed flagship Receiver and BatchRunner through the loop
    kernels against the same with their plain versions patched in; then
    kernels and ms per replayed step of both runners, in turns."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.pipeline.batch import BatchRunner
    p = flagship_params(fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = make_input(geo, seed=4, steps=BATCH_STEPS)
    loops = loop_counts()
    counts = lambda: {n: (w.launches, w.captured) for n, w in loops.items()}
    c0 = counts()
    kern = run_rx(p, iq[:STEPS * geo.samples_per_step], "cuda")
    c1 = counts()
    ref = with_loop_references(
        lambda: run_rx(p, iq[:STEPS * geo.samples_per_step], "cuda"))
    if counts() != c1 or any(c1[n][1] <= c0[n][1] for n in loops):
        raise AssertionError("loops chain: the kernels were not recorded in "
                             "the Receiver's graph, or the plain run "
                             "reached them")
    compare_runs(kern, ref, flagship_shapes(geo), "loops chain: ",
                 start_tol=LOOP_START_TOL,
                 what="graphed Receiver through the loop kernels against "
                      "their plain versions")
    lowered_fit_reading(p, iq[:STEPS * geo.samples_per_step], kern, geo)
    fields = ("audio", "baseb", "fft2_power", "liminfo", "blanker_fitted",
              "blanker_cleared")

    def runner():
        br = BatchRunner(p, k_steps=BATCH_K, outputs=fields)
        br.tune(TUNE_HZ)
        return br

    bk = runner()
    br = with_loop_references(runner)
    compare_batches(bk.process(iq), br.process(iq), geo,
                    "loops chain: BatchRunner through the loop kernels "
                    "against their plain versions")
    stats = {}
    for name, run in (("kernels", bk), ("plain", br)):
        prof = profile_call(run._run_call)
        stats[name] = (prof["ops"] / BATCH_K, prof["busy_ms"] / BATCH_K)
    eager_batch(p, TUNE_HZ, iq, bk.device)     # ends in the fast regime
    times: dict = {}
    for name in ("kernels", "plain", "plain", "kernels"):
        run = bk if name == "kernels" else br
        times.setdefault(name, []).append(timed_ms(run._run_call) / BATCH_K)
    for name, (ops, busy) in stats.items():
        ms = times[name]
        print(f"loops chain: graphed flagship step ({name}), "
              f"{ops:.0f} device kernels and copies per step, {busy:.3f} ms "
              f"of device time per step (torch.profiler); replays alone "
              f"{min(ms):.3f}-{max(ms):.3f} ms per step (CUDA events around "
              f"{BATCH_K} replays, in turns) [{dev['smi']}]", flush=True)


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


def rx_launches(rx, wrapper_before: int) -> int:
    """The fused fft1's launches by ``rx`` (a receiver made with
    ``recorded=recorded_fft1``) since the wrapper's own count read
    ``wrapper_before``: its graphs' replays times the kernel calls recorded
    in them, plus the wrapper's eager calls.  The warm-up before a capture,
    when the receiver is made, is not a step of the path."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    return rx.kernel_launches + fused_fft1.launches - wrapper_before


def run_rx_counted(p, iq: np.ndarray, device, calibration=None,
                   tune_hz: float = TUNE_HZ, graphed=None) -> tuple:
    """A Receiver on ``device`` (graphed on a card unless ``graphed`` says
    otherwise) tuned to ``tune_hz`` over every step of iq: (the outputs
    after the device has finished, the fused fft1's launches in the run,
    as ``rx_launches`` counts them)."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, calibration, device=device, graphed=graphed,
                  recorded=recorded_fft1)
    rx.tune(tune_hz)
    before = fused_fft1.launches
    outs = list(rx.run(iq))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return outs, rx_launches(rx, before)


def run_rx(p, iq: np.ndarray, device, calibration=None,
           tune_hz: float = TUNE_HZ, graphed=None) -> list:
    """A Receiver on ``device`` tuned to ``tune_hz`` over every step of
    iq; the outputs after the device has finished."""
    return run_rx_counted(p, iq, device, calibration, tune_hz, graphed)[0]


def phase_main() -> tuple[int, dict]:
    """Returns the fused kernel's launch count over the main path's steps,
    and each loop kernel's."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import Receiver
    geo = derive_geometry(flagship_params())
    iq = make_input(geo)
    loops = loop_counts()
    fused_fft1.launches = 0
    for w in loops.values():
        w.launches = w.captured = 0
    # each graph reads ``recorded`` just before and just after its
    # capture: the loop kernels' captured counts at each read give what
    # each graph recorded of each
    reads = []

    def recorded():
        reads.append({n: w.captured for n, w in loops.items()})
        return recorded_fft1()

    rx = Receiver(flagship_params(fft1_variant="pallas"), device="cuda",
                  recorded=recorded)
    rx.tune(TUNE_HZ)
    graphs = list(rx.graphs.values())
    if len(reads) != 2 * len(graphs):
        raise AssertionError(f"{len(graphs)} graphs read the capture count "
                             f"{len(reads)} times")
    made = {n: w.launches for n, w in loops.items()}
    before = fused_fft1.launches
    outs = list(rx.run(iq))
    torch.cuda.synchronize()
    launches = rx_launches(rx, before)
    per_graph = [{n: after[n] - start[n] for n in loops}
                 for start, after in zip(reads[::2], reads[1::2])]
    loop_launches = {n: sum(g.replays * k[n]
                            for g, k in zip(graphs, per_graph))
                     + w.launches - made[n] for n, w in loops.items()}
    print(f"main path: {len(outs)} steps of {geo.samples_per_step} samples "
          f"through the graphed Receiver, fused_fft1 launches {launches} "
          f"(replays of the kernel recorded in the graph; the wrapper's own "
          f"count, the capture's warm-up included, {fused_fft1.launches}); "
          + "; ".join(f"{n} launches {loop_launches[n]} (the wrapper's own "
                      f"count {w.launches}; recorded per graph "
                      f"{[k[n] for k in per_graph]}, replays "
                      f"{[g.replays for g in graphs]})"
                      for n, w in loops.items()))
    if launches != STEPS or len(outs) != STEPS:
        raise AssertionError(f"expected {STEPS} kernel launches (one per "
                             f"step), saw {launches}")
    if any(loop_launches[n] < STEPS or w.launches == 0
           for n, w in loops.items()):
        raise AssertionError(f"the loop kernels were not launched on the "
                             f"main path: {loop_launches}")
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
    return launches, loop_launches


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
                 what: str = "pallas vs xla on the card",
                 tol: dict | None = None) -> None:
    """The receiver through the kernel (outs) against the receiver through
    torch.fft (ref), or the two receivers ``what`` names: blanker counts
    and the liminfo sign pattern exact in every step, each float field
    within its bar (CHAIN_TOL, or ``tol``; CHAIN_TOL_OTHER for a field
    neither names; step 0's audio within START_AUDIO_TOL, or step 0's
    fields within ``start_tol``)."""
    start_tol = start_tol or {"audio": START_AUDIO_TOL}
    tol = CHAIN_TOL if tol is None else tol
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
            bar = tol.get(k, CHAIN_TOL_OTHER)
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
        # the eager step (phase 21 times the graphed one)
        rx = Receiver(flagship_params(fft1_variant=variant), device="cuda",
                      graphed=False)
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


def run_eme(p, iq: np.ndarray, device: str, graphed=None) -> tuple:
    """Receiver tuned to the dial over EME_STEPS steps of iq.  Returns
    (receiver, outputs, AFC trajectory: (status, freq_hz, tune bins) per
    step, the fused fft1's launches in the run)."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, device=device, graphed=graphed, recorded=recorded_fft1)
    rx.tune(EME_TUNE_HZ)
    s = rx.geo.samples_per_step
    outs, track = [], []
    before = fused_fft1.launches
    for i in range(EME_STEPS):
        outs.append(rx.process_block(iq[i * s:(i + 1) * s]))
        track.append((rx.afc.status, rx.afc.freq_hz,
                      rx._tune_bin.cpu().numpy()))
    return rx, outs, track, rx_launches(rx, before)


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
    rx, outs, track, launches = run_eme(p, iq, device)
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

    _, ref, ref_track, _ = run_eme(eme_params("xla", **overrides), iq,
                                   device)
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


def phase_eme_timing(dev: dict, rx, iq: np.ndarray, what: str = "") -> dict:
    """EME step time in turns: through Receiver.process_block (the AFC's
    fft2_power read to the host every step) and the receiver's bare step
    (``Receiver._advance``: the graph's replay, or the eager step, with the
    AFC's last per-frame tuning held fixed; no host read, no copy of the
    outputs).  Returns the ms per step of each turn by label."""
    s = rx.geo.samples_per_step
    blocks = [torch.from_numpy(iq[(EME_STEPS + i) * s:
                                  (EME_STEPS + i + 1) * s]).cuda()
              for i in range(EME_TIME_STEPS)]
    mode = "graphed" if rx.graphed else "eager"

    def receiver():
        for b in blocks:
            rx.process_block(b)

    def bare():
        for b in blocks:
            rx._advance(b)

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
        print(f"{what}eme timing {mode} {label}: {ms:.3f} ms/step (CUDA "
              f"events), host {1e3 * host_s / len(blocks):.3f} ms/step, "
              f"{s / ms / 1e3:.3f} complex Msamples/s per channel "
              f"[{dev['smi']}]")
    reads = (rx.control.host_reads - reads0) / (2 * len(blocks))
    cost = (sum(times["receiver"]) - sum(times["bare step"])) / 2
    print(f"{what}eme timing {mode}: {reads:.0f} fft2_power host read per "
          f"Receiver step; Receiver minus bare step {cost:.3f} ms/step")
    if reads != 1:
        raise AssertionError("expected one host read per Receiver step")
    return times


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
              scan_interval: int | None = None, graphed=None):
    """MultiReceiver over ``steps`` steps with the spur manager scanning
    beside it.  ``device`` None takes the receiver's default;
    ``scan_interval`` overrides the control's (a rehearsal at a tiny step
    size, where the interval is far longer than the run).  Returns
    (receiver, control, outputs, spur slot bins after each step, the fused
    fft1's launches in the run)."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.control import WeakSignalControl
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    kw = {"graphed": graphed, "recorded": recorded_fft1}
    rx = (MultiReceiver(p, k_sub, **kw) if device is None
          else MultiReceiver(p, k_sub, device=device, **kw))
    for k, f in enumerate(dials):
        rx.tune_subch(k, f)
    ctl = WeakSignalControl(rx.geo, p, rx.device)
    if ctl.spur_manager is not None:
        ctl.spur_manager = dial_protecting_manager(rx.geo, dials)
    if scan_interval:
        ctl.spur_scan_interval = scan_interval
    s = rx.geo.samples_per_step
    outs, slots = [], []
    before = fused_fft1.launches
    for i in range(steps):
        out = rx.process_block(iq[i * s:(i + 1) * s])
        _bins, rx.state = ctl.update(out, rx._tune_bins, rx.state)
        outs.append(out)
        slots.append(None if rx.state.spur is None
                     else rx.state.spur.bins.cpu().numpy().copy())
    return rx, ctl, outs, slots, rx_launches(rx, before)


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
    rx, ctl, outs, slots, launches = run_multi(p, k_sub, dials, iq, steps,
                                               device, scan_interval)
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
    _, _, plain, _, _ = run_multi(multi_params("pallas", tiny, spur=False),
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
    _, _, ref, ref_slots, _ = run_multi(multi_params("xla", tiny), k_sub,
                                        dials, iq, steps, device,
                                        scan_interval)
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
        # the eager step, whose aten operations are counted (phase 21
        # times the graphed one)
        rx = MultiReceiver(p, k_sub, graphed=False)
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
    rx = Receiver(p, device=device, audio_out_rate=fs_out,
                  recorded=recorded_fft1)
    fused_fft1.launches = 0
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
          f"{block_out}), fused_fft1 launches {rx_launches(rx, 0)}")
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
    real_launches = rx_launches(rx, 0)

    # I/Q image correction on IQ input: the unfused path as well
    geo_iq = derive_geometry(base)
    corr = 0.01 * (rng.normal(size=geo_iq.fft1_size)
                   + 1j * rng.normal(size=geo_iq.fft1_size))
    iq = make_input(geo_iq, seed=6, steps=3)
    s = geo_iq.samples_per_step
    powers = []
    for cal in ({"iq_corr": corr.astype(np.complex64)}, None):
        rx = Receiver(base, device=device, calibration=cal,
                      recorded=recorded_fft1)
        rx.tune(TUNE_HZ)
        before = fused_fft1.launches
        outs = [rx.process_block(iq[i * s:(i + 1) * s]) for i in range(3)]
        check_outputs(outs, {"audio": (geo_iq.baseband_samples_per_step, 1),
                             "fft1_power": (geo_iq.fft1_size, 1)})
        if cal is not None:
            corr_launches = rx_launches(rx, before)
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
        br = BatchRunner(params, k_steps=BATCH_K, recorded=recorded_fft1,
                         **kw)
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
          f"{fused_fft1.launches} times); capture {capture_s(g):.3f} s, "
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
    EME configuration.  Returns the kernel's launch count: the launches of
    the phase's receivers, as ``rx_launches`` counts them."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline.checkpoint import (load_receiver,
                                                      save_receiver)
    from linrad_tpu_torch.pipeline.receiver import Receiver
    fused_fft1.launches = 0
    made = []

    def receiver(params):
        made.append(Receiver(params, device=device, recorded=recorded_fft1))
        return made[-1]

    def load(path):
        made.append(load_receiver(path, device=device,
                                  recorded=recorded_fft1))
        return made[-1]

    with tempfile.TemporaryDirectory() as tmp:
        p = flagship_params(tiny=tiny, fft1_variant="pallas")
        rx = receiver(p)
        rx.tune(TUNE_HZ)
        s = rx.geo.samples_per_step
        iq = make_input(rx.geo, seed=4, steps=8)
        straight = list(rx.run(iq))
        rx1 = receiver(p)
        rx1.tune(TUNE_HZ)
        for _ in rx1.run(iq[:4 * s]):
            pass
        path = os.path.join(tmp, "flagship.npz")
        save_receiver(path, rx1)
        rx2 = load(path)
        for i, out in enumerate(rx2.run(iq[4 * s:])):
            equal_outputs(out, straight[4 + i], f"checkpoint step {5 + i}")
        print(f"checkpoint: flagship, saved after 4 steps "
              f"({os.path.getsize(path)} bytes), resumed on {rx2.device}: "
              f"every output field of steps 5-8 bit-equal to the "
              f"uninterrupted run")

        pe = eme_params("pallas", **eme_overrides)
        iq = make_eme_input(derive_geometry(pe), EME_STEPS)
        rx = receiver(pe)
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
                rx2 = load(path)
                saved_at = i
        if rx2 is None or len(resumed) < 3 or 3 not in track:
            raise AssertionError(f"checkpoint: the AFC did not lock in time "
                                 f"to resume: {track}")
        print(f"checkpoint: eme, AFC status per step {track}, saved after "
              f"step {saved_at} (status {track[saved_at]}), resumed over "
              f"steps {saved_at + 1}-{EME_STEPS - 1} (status {resumed}): "
              f"outputs, AFC status and frequency, frame bins, tune_frac "
              f"and tune_slope equal in every step")
    # every receiver here is graphed on the card: its replays are the
    # launches (the wrapper's own count holds the captures' warm-ups)
    return sum(r.kernel_launches for r in made)


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
        rx = Receiver(p, device=device, recorded=recorded_fft1)
        rx.tune(TUNE_HZ)
        fused_fft1.launches = 0
        t0 = time.perf_counter()
        outs = list(rx.run_file(path))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = rx_launches(rx, 0)
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
    outs, receiver_launches = run_rx_counted(p, iq, device)
    shapes = flagship_shapes(geo)
    check_outputs(outs, shapes)
    seq = run_rx(base, iq, device)
    fits = [int(o.blanker_fitted) for o in outs]
    seq_fits = [int(o.blanker_fitted) for o in seq]
    print(f"rounds: blanker_rounds={ROUNDS}, Receiver {len(outs)} steps, "
          f"fused_fft1 launches {receiver_launches}; fits per step {fits} "
          f"(sequential blanker, up to {p.max_pulses_per_block}: "
          f"{seq_fits}); cleared "
          f"{[int(o.blanker_cleared) for o in outs]} "
          f"(sequential {[int(o.blanker_cleared) for o in seq]})")
    if on_card and receiver_launches != STEPS:
        raise AssertionError(f"rounds: expected {STEPS} kernel launches")
    # (at the tiny size phase 4's impulses stay under the fit threshold)
    if max(fits) == 0 and not tiny:
        raise AssertionError("rounds: the blanker fitted nothing")
    compare_runs(outs, run_rx(dataclasses.replace(p, fft1_variant="xla"),
                              iq, device), shapes, "rounds: ")

    iq16 = make_input(geo, seed=2, steps=BATCH_STEPS)
    br = BatchRunner(p, k_steps=BATCH_K, device=device,
                     recorded=recorded_fft1)
    br.tune(TUNE_HZ)
    fused_fft1.launches = 0
    got = br.process(iq16)
    batch_launches = br.kernel_launches
    wrapper = fused_fft1.launches
    print(f"rounds: BatchRunner k_steps={BATCH_K}, {BATCH_STEPS} steps, "
          f"{br.kernels_per_replay} fused_fft1 node(s) per replay, launches "
          f"{batch_launches} (wrapper calls {wrapper}); capture "
          f"{capture_s(br.graphed):.3f} s")
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
    return receiver_launches + batch_launches


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
    mxu, launches = run_rx_counted(mxu_p, iq, device)
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
    bf, bf_launches = run_rx_counted(bf_p, iq, device)
    launches += bf_launches
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
    outs, launches = run_rx_counted(base, iq, device, cal)
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
                         device=device, recorded=recorded_fft1)
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
          f"{capture_s(fl.graphed):.3f} s, graph pool {pool} bytes "
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


def shard_dial(geo) -> float:
    """TUNE_HZ moved to the nearest fftx bin centre: the sharded steps tune
    to whole bins, and a Receiver tuned there adds no fractional ramp, so
    the two can be compared."""
    fs, n = geo.timf1_sampling_speed, geo.fftx_size
    return round(TUNE_HZ / fs * n) * fs / n


def run_sharded_counted(p, iq: np.ndarray, devices, tune_hz: float,
                        graphed=None) -> tuple:
    """A ShardedReceiver over ``devices`` (a list, or a shard group;
    graphed where every shard is on one card, unless ``graphed`` says
    otherwise) tuned to ``tune_hz`` over every step of iq: (the outputs
    after the devices have finished, the fused fft1's launches in the run,
    as ``rx_launches`` counts them)."""
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import ShardedReceiver
    rx = ShardedReceiver(p, devices, graphed=graphed, recorded=recorded_fft1)
    rx.tune(tune_hz)
    before = fused_fft1.launches
    outs = list(rx.run(iq))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return outs, rx_launches(rx, before)


def run_sharded(p, iq: np.ndarray, devices, tune_hz: float,
                graphed=None) -> list:
    """The outputs of ``run_sharded_counted``."""
    return run_sharded_counted(p, iq, devices, tune_hz, graphed)[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max|b|, the JAX package's sharded tests' measure."""
    return ((a - b).abs().max() / b.abs().max()).item()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind((LOOPBACK, 0))
        return s.getsockname()[1]


def phase_sharded(dev: dict, device="cuda", tiny: bool = False) -> int:
    """The flagship split over SHARD_D time shards on one device.  Returns
    the kernel's launches over the phase's runs that launch it (the
    single-device Receiver compared with, and the two fleets)."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import (ShardedBatchRunner,
                                           ShardedMultiReceiver)
    on_card = torch.device(device).type == "cuda"
    p = dataclasses.replace(flagship_params(tiny=tiny), shards=SHARD_D)
    geo = derive_geometry(p)
    dial = shard_dial(geo)
    iq = make_input(geo, steps=SHARD_STEPS)
    card = [device] * SHARD_D
    shapes = flagship_shapes(geo)
    fused_fft1.launches = 0
    t0 = time.perf_counter()
    outs, shard_launches = run_sharded_counted(p, iq, card, dial)
    seconds = time.perf_counter() - t0
    print(f"sharded: ShardedReceiver over {card}, {len(outs)} steps of "
          f"{geo.samples_per_step} samples ({geo.samples_per_step // SHARD_D}"
          f" a shard, {geo.fft1_frames_per_step // SHARD_D} fft1 frames), "
          f"{seconds:.2f} s with its captures; fused_fft1 launches "
          f"{shard_launches}, wrapper calls {fused_fft1.launches} (the "
          f"sharded step takes no fused kernel, as the JAX package's); fits "
          f"{[int(o.blanker_fitted) for o in outs]}, cleared "
          f"{[int(o.blanker_cleared) for o in outs]}")
    if fused_fft1.launches or shard_launches:
        raise AssertionError("sharded: the sharded step launched the fused "
                             "fft1 kernel")
    check_outputs(outs, shapes)
    if not tiny and max(int(o.blanker_fitted) for o in outs) == 0:
        raise AssertionError("sharded: the blanker fitted nothing")
    ref = run_sharded(p, iq[:SHARD_CPU_STEPS * geo.samples_per_step],
                      ["cpu"] * SHARD_D, dial)
    compare_runs(outs[:SHARD_CPU_STEPS], outputs_on(ref, device), shapes,
                 "sharded: ",
                 what=f"{device} x {SHARD_D} vs cpu x {SHARD_D}",
                 tol=SHARD_TOL)
    # against the single-device Receiver: the JAX test's comparison has
    # the stupid blanker off (its threshold follows the noise floor, which
    # the sharded step takes as the mean of per-shard despiked means, so
    # one sample near it may be cleared on one side only)
    single = run_rx(p, iq, device, tune_hz=dial)
    print("sharded: with the stupid blanker on, baseb max|diff|/max per "
          "step against the single-device Receiver " + str([
              f"{rel_err(a.baseb, b.baseb):.1e}"
              for a, b in zip(outs, single)]) + ", cleared "
          f"{[int(o.blanker_cleared) for o in single]} (not held)")
    q = dataclasses.replace(p, stupid_bln_limit=1e9)
    outs_q = run_sharded(q, iq, card, dial)
    single, launches = run_rx_counted(q, iq, device, tune_hz=dial)
    fit_s = sum(int(o.blanker_fitted) for o in outs_q)
    fit_1 = sum(int(o.blanker_fitted) for o in single)
    rel = rel_err(torch.cat([o.baseb for o in outs_q]),
                  torch.cat([o.baseb for o in single]))
    print(f"sharded: stupid blanker off, against the single-device Receiver "
          f"({launches} fused_fft1 launches): fits {fit_s} against {fit_1}, "
          f"baseb max|diff|/max {rel:.3e} (bars: fits >= single - 1, under "
          f"{SHARD_SINGLE_BASEB})")
    if fit_s < fit_1 - 1 or rel >= SHARD_SINGLE_BASEB:
        raise AssertionError("sharded: too far from the single-device step")
    if on_card and launches != SHARD_STEPS:
        raise AssertionError(f"sharded: the Receiver made {launches} "
                             f"launches, expected {SHARD_STEPS}")

    br = ShardedBatchRunner(p, k_steps=SHARD_K, outputs=("audio", "baseb"),
                            devices=card)
    br.tune(dial)
    got = br.process(iq)
    equal = all(np.array_equal(got[f], torch.cat(
        [getattr(o, f) for o in outs]).cpu().numpy())
        for f in ("audio", "baseb"))
    print(f"sharded: ShardedBatchRunner(k_steps={SHARD_K}) over "
          f"{SHARD_STEPS} steps bit-equal to the streamed receiver: {equal}")
    if not equal:
        raise AssertionError("sharded: batch runner differs from streamed")

    dials = multi_dials(geo, SHARD_SUB)
    iq3 = make_input(geo, seed=2, steps=SHARD_SUB_STEPS, tones=dials,
                     tone_amplitude=MULTI_TONE_AMPLITUDE)
    mx = ShardedMultiReceiver(p, SHARD_SUB, card)
    for k, f in enumerate(dials):
        mx.tune_subch(k, f)
    mouts = list(mx.run(iq3))
    for k, f in enumerate(dials):
        one = run_sharded(p, iq3, card, f)
        worst = {fld: max_rel(torch.cat([getattr(o, fld)[k] for o in mouts]),
                              torch.cat([getattr(o, fld) for o in one]))
                 for fld in ("audio", "baseb", "agc_gain")}
        print(f"sharded: ShardedMultiReceiver sub-receiver {k} (dial "
              f"{f:.1f} Hz) against a ShardedReceiver: " + ", ".join(
                  f"{fld} max_rel {v:.3e}" for fld, v in worst.items())
              + f" (bar {SHARD_SUB_TOL})")
        # (at the tiny size sellim calls most bins strong, and the front's
        # protected passband follows sub-receiver 0's dial only)
        if max(worst.values()) > SHARD_SUB_TOL and not tiny:
            raise AssertionError(f"sharded: sub-receiver {k} differs")

    phase_dist_group(p, iq[:SHARD_DIST_STEPS * geo.samples_per_step],
                     device, dial)
    launches += phase_fleet_devices(dev, device, tiny)
    if on_card:
        phase_sharded_timing(dev, p, iq)
        phase_parity_report(device)
    return launches


def phase_dist_group(p, iq: np.ndarray, device, dial: float) -> None:
    """DistGroup at world size 1 (NCCL on a card, gloo on the CPU, from a
    free localhost port) with SHARD_D local shards: bit-equal to
    LocalGroup.  NCCL refuses two ranks on one card, so traffic between
    processes is tested on the CPU only (tests/test_torch_multihost.py)."""
    import torch.distributed as dist
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.parallel import LocalGroup, global_time_mesh
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{LOOPBACK}:{free_port()}",
                            rank=0, world_size=1)
    try:
        outs = run_sharded(p, iq, global_time_mesh([device] * SHARD_D),
                           dial)
    finally:
        dist.destroy_process_group()
    ref = run_sharded(p, iq, LocalGroup([device] * SHARD_D), dial)
    equal = all(torch.equal(getattr(a, f), getattr(b, f))
                for a, b in zip(outs, ref)
                for f in flagship_shapes(derive_geometry(p)))
    print(f"sharded: DistGroup ({backend}, world size 1, {SHARD_D} local "
          f"shards) against LocalGroup over {len(outs)} steps, every field "
          f"bit-equal: {equal}")
    if not equal:
        raise AssertionError("sharded: DistGroup differs from LocalGroup")


def phase_fleet_devices(dev: dict, device="cuda", tiny: bool = False) -> int:
    """FleetRunner over [device, device]: bit-equal to the two runners of
    half the streams it composes, and against one FleetRunner of all the
    streams on device to phase 4's bars (the fused kernel sums each
    channel's power in an order that depends on the channels a launch
    serves).  Returns the kernel's launches of the four runners, as they
    count them."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import FleetRunner
    on_card = torch.device(device).type == "cuda"
    p = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(p)
    dials = fleet_dials(geo, FLEET_R)
    iq = np.stack([make_input(geo, steps=FLEET_STEPS, tones=(f,))[:, 0]
                   for f in dials])
    h = FLEET_R // 2

    def fleet(n, where, lo=0):
        fl = FleetRunner(p, n, k_steps=FLEET_K, outputs=FLEET_FIELDS,
                         device=where, recorded=recorded_fft1)
        fl.tune(dials[lo:lo + n])
        return fl, fl.process(iq[lo:lo + n])

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=VMAP_SLOW_PATH)
        fused_fft1.launches = 0
        two, got = fleet(FLEET_R, [device, device])
        halves = [fleet(h, device, lo) for lo in (0, h)]
        one, ref = fleet(FLEET_R, device)
    equal = all(np.array_equal(got[f], np.concatenate(
        [out[f] for _fl, out in halves])) for f in FLEET_FIELDS)
    bb = geo.baseband_samples_per_step
    worst = {f: (max(max_rel(torch.from_numpy(got[f][r, :bb]),
                             torch.from_numpy(ref[f][r, :bb]))
                     for r in range(FLEET_R)),
                 max(max_rel(torch.from_numpy(got[f][r, bb:]),
                             torch.from_numpy(ref[f][r, bb:]))
                     for r in range(FLEET_R))) for f in FLEET_FIELDS}
    launches = (two.kernel_launches + one.kernel_launches
                + sum(fl.kernel_launches for fl, _out in halves))
    print(f"fleet devices: FleetRunner({FLEET_R} streams, device="
          f"{[device, device]}) {FLEET_STEPS} steps: {two.kernels_per_replay}"
          f" fused_fft1 node(s) per replayed step (one per device's graph), "
          f"launches {two.kernel_launches}; bit-equal to two runners of {h} "
          f"streams: {equal}; against one runner of {FLEET_R} streams ("
          f"{one.kernels_per_replay} node per step, {one.kernel_launches} "
          f"launches): " + "; ".join(
              f"{f} step 0 max_rel {a:.3e}, steps 1-{FLEET_STEPS - 1} "
              f"{b:.3e}" for f, (a, b) in worst.items())
          + f"; wrapper calls {fused_fft1.launches} [{dev['smi']}]")
    if not equal:
        raise AssertionError("fleet devices: differs from its two runners")
    bar0 = {"audio": START_AUDIO_TOL, "baseb": CHAIN_TOL_OTHER}
    bar = {"audio": CHAIN_TOL["audio"], "baseb": CHAIN_TOL_OTHER}
    if not tiny and any(a > bar0[f] or b > bar[f]
                        for f, (a, b) in worst.items()):
        raise AssertionError("fleet devices: outside phase 4's bars")
    if on_card and (two.kernels_per_replay != 2
                    or two.kernel_launches != 2 * FLEET_STEPS
                    or one.kernel_launches != FLEET_STEPS):
        raise AssertionError("fleet devices: expected one kernel launch per "
                             "step on each device's graph")
    return launches


def phase_sharded_timing(dev: dict, p, iq: np.ndarray) -> None:
    """Eager sharded step ms (CUDA events) and device kernels per step
    (torch.profiler) at d = SHARD_TIME_D shards on one card, in turns."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.parallel import ShardedReceiver
    s = derive_geometry(p).samples_per_step
    blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
              for i in range(2 + SHARD_TIME_STEPS)]
    kernels: dict = {}
    times: dict = {}
    for d in SHARD_TIME_D + SHARD_TIME_D[::-1]:
        # the eager step (phase 21 holds the graphed one)
        rx = ShardedReceiver(dataclasses.replace(p, shards=d),
                             ["cuda:0"] * d, graphed=False)
        rx.tune(shard_dial(rx.geo))
        for b in blocks[:2]:
            rx.process_block(b)
        if d not in kernels:
            kernels[d] = profile_call(
                lambda: rx.process_block(blocks[2]))["ops"]
        ms = timed_ms(lambda: [rx.process_block(b)
                               for b in blocks[2:]]) / SHARD_TIME_STEPS
        times.setdefault(d, []).append(ms)
        print(f"sharded timing d={d}: {ms:.3f} ms per eager step, "
              f"{kernels[d]} device kernels and copies per step, "
              f"{s / ms / 1e3:.3f} complex Msamples/s [{dev['smi']}]")
    print("sharded timing: " + "; ".join(
        f"d={d} {min(v):.3f}-{max(v):.3f} ms, x{min(v) / min(times[1]):.2f}"
        f" of d=1" for d, v in times.items()))


def phase_parity_report(device) -> None:
    """The parity report's five configurations at full width on the card:
    every one must pass."""
    from linrad_tpu_torch.examples import parity_report
    res = parity_report.main(device=device)
    if not all(res["passed"].values()):
        raise AssertionError(f"parity report: {res['passed']}")


def qual_params():
    """The qualification's receiver: 96 kHz IQ, fft1 8192, 262,144
    samples per step, AFC and the coherent detector, AGC off."""
    from linrad_tpu_torch import Demod, RxParams
    return RxParams(first_fft_bandwidth=30.0, mix1_bandwidth_reduction_n=4,
                    agc_enable=False, afc_enable=True, demod=Demod.COHERENT,
                    bfo_hz=600.0, filter_low_hz=-100.0, filter_high_hz=100.0)


def qual_input(geo, snr_db: float, seed: int) -> np.ndarray:
    """QUAL_MSG keyed at 20 WPM on a carrier at QUAL_FC drifting 0.5 Hz/s,
    two steps of silence after it, complex Gaussian noise at ``snr_db`` in
    2500 Hz: the JAX package's qualification input, sample for sample."""
    from linrad_tpu_torch.weak.cw import keyed_cw
    fs = geo.rx_ad_speed
    key = keyed_cw(QUAL_MSG, fs, 20.0, 0.0)
    n = (len(key) // geo.samples_per_step + 2) * geo.samples_per_step
    sig = np.zeros(n, np.complex64)
    sig[:len(key)] = key
    t = np.arange(n) / fs
    clean = sig * np.exp(2j * np.pi * (QUAL_FC * t + 0.25 * t ** 2))
    sigma = np.sqrt(1.0 / (2 * (2500 / fs) * 10 ** (snr_db / 10)))
    rng = np.random.default_rng(seed)
    return (clean + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def cw_params(fft1_variant: str):
    """test_full_chain_decode's receiver: fft1 2048, 65,536 samples per
    step, SSB at a 700 Hz BFO, AGC off."""
    from linrad_tpu_torch import RxParams
    return RxParams(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                    agc_enable=False, bfo_hz=700.0, filter_low_hz=-400.0,
                    filter_high_hz=400.0, fft1_variant=fft1_variant)


def cw_input(geo) -> np.ndarray:
    """CW_MSG at 20 WPM on CW_TUNE_HZ with noise (seed 1), padded to whole
    steps, as test_full_chain_decode makes it."""
    from linrad_tpu_torch.weak.cw import keyed_cw
    cw = keyed_cw(CW_MSG, geo.rx_ad_speed, 20, CW_TUNE_HZ)
    pad = ((len(cw) // geo.samples_per_step + 1) * geo.samples_per_step
           - len(cw))
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    rng = np.random.default_rng(1)
    return cw + 0.02 * (rng.normal(size=len(cw))
                        + 1j * rng.normal(size=len(cw))).astype(np.complex64)


def np_max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return max_rel(torch.from_numpy(np.asarray(a)),
                   torch.from_numpy(np.asarray(b)))


def phase_weak_qualification(dev: dict, device="cuda") -> None:
    """Phase 19a: the qualification at full width through the port's
    Receiver on ``device``, the baseband against the same Receiver on the
    CPU, and decode_morse_ml of the card's baseband, which must read
    QUAL_MSG exactly."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline import Receiver
    from linrad_tpu_torch.utils.host import to_numpy
    from linrad_tpu_torch.weak.cw import decode_morse_ml
    p = qual_params()
    geo = derive_geometry(p)
    fs_bb = geo.baseband_sampling_speed

    def baseband(iq, where):
        rx = Receiver(p, device=where)
        rx.tune(QUAL_FC)
        t0 = time.perf_counter()
        outs, status = [], []
        for out in rx.run(iq):
            outs.append(out)
            status.append(rx.afc.status)
        bb = np.concatenate([to_numpy(o.baseb) for o in outs])[:, 0]
        return bb, status, time.perf_counter() - t0

    for snr_db, seed in QUAL_RUNS:
        t0 = time.perf_counter()
        iq = qual_input(geo, snr_db, seed)
        bb, status, rx_s = baseband(iq, device)
        ref, ref_status, cpu_s = baseband(iq, "cpu")
        n = len(iq) // geo.samples_per_step * geo.baseband_samples_per_step
        if bb.shape != (n,) or not np.isfinite(bb).all():
            raise AssertionError(f"qualification baseb of shape {bb.shape},"
                                 f" expected ({n},), or non-finite values")
        t1 = time.perf_counter()
        res = decode_morse_ml(bb, fs_bb)
        decode_s = time.perf_counter() - t1
        rel = np_max_rel(bb, ref)
        print(f"weak qualification {snr_db:+.0f} dB/2500 Hz seed {seed}: "
              f"{len(status)} steps of {geo.samples_per_step} samples at fft1 "
              f"{geo.fft1_size}; AFC status per step {status} (CPU "
              f"{ref_status}); baseb card vs CPU max_rel {rel:.3e}; "
              f"decode_morse_ml {res.text!r} at {res.wpm:.1f} WPM; receiver "
              f"{rx_s:.2f} s on {device}, {cpu_s:.2f} s on the CPU, decoder "
              f"{decode_s:.2f} s on the host; part {time.perf_counter() - t0:.1f}"
              f" s [{dev['smi']}]")
        if res.text != QUAL_MSG:
            raise AssertionError(f"qualification at {snr_db} dB: decoded "
                                 f"{res.text!r}, expected {QUAL_MSG!r}")


def drain_taps(nets: dict, pub, got: dict) -> None:
    """Read every packet the publisher has sent so far into ``got``."""
    from linrad_tpu_torch.io import taps
    for fmt, net in nets.items():
        while len(got[fmt]) < pub.senders[fmt].block_no * taps.PAYLOAD_BYTES:
            r = net.recv()
            if r is None:
                raise AssertionError(f"tap {fmt}: a packet did not arrive")
            got[fmt] += r[1]


def phase_weak(dev: dict, device="cuda") -> int:
    """Phase 19, the weak-signal decode and the operator's path.  Returns
    the kernel's launches on the CW decode's path."""
    import urllib.request
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.io import taps
    from linrad_tpu_torch.io.httpd import WebGui
    from linrad_tpu_torch.io.publish import TapPublisher
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.pipeline import Receiver
    from linrad_tpu_torch.utils.host import to_numpy
    from linrad_tpu_torch.weak.cw import decode_morse
    on_card = torch.device(device).type == "cuda"
    phase_weak_qualification(dev, device)

    # (b) the CW decode through the fused fft1, (c) with the operator's
    # hooks attached to the same receiver
    t0 = time.perf_counter()
    p = cw_params("pallas")
    geo = derive_geometry(p)
    iq = cw_input(geo)
    s = geo.samples_per_step
    steps = len(iq) // s
    rx = Receiver(p, device=device, recorded=recorded_fft1)
    rx.tune(CW_TUNE_HZ)
    fields = {taps.TAP_BASEB: "audio", taps.TAP_BASEBRAW: "baseb"}
    nets = {f: taps.TapReceiver(f, timeout=5.0, bind=(LOOPBACK, 0))
            for f in fields}
    pub = TapPublisher(fields, dest={f: (LOOPBACK, n.port)
                                     for f, n in nets.items()})
    pub.attach(rx)
    gui = WebGui()
    gui.attach(rx)
    port = gui.serve(host=LOOPBACK)
    got = {f: b"" for f in fields}
    outs = []
    try:
        fused_fft1.launches = 0
        for i in range(steps):
            outs.append(rx.process_block(iq[i * s:(i + 1) * s]))
            drain_taps(nets, pub, got)
        launches = rx_launches(rx, 0)
        rx_s = time.perf_counter() - t0

        def fetch(path):
            with urllib.request.urlopen(f"http://{LOOPBACK}:{port}{path}",
                                        timeout=10) as r:
                return r.read()

        status = json.loads(fetch("/status.json"))
        bmp = fetch("/waterfall.bmp")
    finally:
        gui.close()
        pub.close()
        for net in nets.values():
            net.close()
    print(f"weak cw decode: {steps} steps of {s} samples at fft1 "
          f"{geo.fft1_size}, fused_fft1 launches {launches} "
          f"({geo.fft1_frames_per_step}, {geo.fft1_size}, {geo.channels}) "
          f"per step")
    if on_card and launches != steps:
        raise AssertionError(f"weak: expected {steps} kernel launches, saw "
                             f"{launches}")
    keys = [f.name for f in dataclasses.fields(outs[0])
            if getattr(outs[0], f.name) is not None]
    compare_runs(outs, run_rx(cw_params("xla"), iq, device,
                              tune_hz=CW_TUNE_HZ), keys, "weak: ")
    audio = np.concatenate([to_numpy(o.audio) for o in outs])[:, 0]
    res = decode_morse(audio, geo.baseband_sampling_speed)
    print(f"weak cw decode: decode_morse {res.text!r} at {res.wpm:.1f} WPM; "
          f"part {time.perf_counter() - t0:.1f} s")
    if res.text != CW_MSG:
        raise AssertionError(f"weak: decoded {res.text!r}, expected "
                             f"{CW_MSG!r}")

    # (c) the taps carried the card's outputs bit for bit; the GUI answered
    t1 = time.perf_counter()
    for fmt, attr in fields.items():
        sent = b"".join(to_numpy(getattr(o, attr)).tobytes() for o in outs)
        n = len(got[fmt])
        print(f"weak taps: format {fmt} ({attr}) {n} bytes received of "
              f"{len(sent)} sent on {LOOPBACK}, bit-equal "
              f"{got[fmt] == sent[:n]}")
        if n < taps.PAYLOAD_BYTES or got[fmt] != sent[:n]:
            raise AssertionError(f"weak: tap {fmt} does not carry the "
                                 f"outputs bit for bit")
    w, h = struct.unpack("<ii", bmp[18:26])
    print(f"weak gui: /status.json steps {status['steps']}, s_meter "
          f"{status['s_meter']}, audio_rate {status['audio_rate']}; "
          f"/waterfall.bmp {len(bmp)} bytes, {w} x {h}")
    if status["steps"] != steps or bmp[:2] != b"BM" or h != steps:
        raise AssertionError("weak: the web GUI did not answer as expected")
    phase_weak_tx(dev, device)
    print(f"weak operator part {time.perf_counter() - t1:.1f} s")
    return launches


def phase_weak_tx(dev: dict, device="cuda") -> None:
    """The transmit streamer with its resampler on ``device`` against the
    same streamer on the CPU, TX_BLOCKS mic blocks of a two-tone: every
    D/A block within TX_TOL; ms per pumped block on the device."""
    from linrad_tpu_torch.tx import SsbTxStreamer
    fs_ad, fs_da, block = 12_000, 48_000, 1024
    t = np.arange(TX_BLOCKS * block) / fs_ad
    mic = (0.4 * np.sin(2 * np.pi * 700.0 * t)
           + 0.4 * np.sin(2 * np.pi * 1900.0 * t)).astype(np.float32)
    out, secs = {}, {}
    for where in (device, "cpu"):
        tx = SsbTxStreamer(fs_ad, fs_da, block, device=where)
        tx.push_mic(mic[:block])
        tx.pump()                     # the first block builds the kernels
        tx.push_mic(mic[block:])
        t0 = time.perf_counter()
        tx.pump()
        secs[where] = time.perf_counter() - t0
        blocks = []
        while (b := tx.pop_dac()) is not None:
            blocks.append(b)
        out[where] = blocks
    worst = max(np_max_rel(a, b) for a, b in zip(out[device], out["cpu"]))
    n = TX_BLOCKS - 1
    print(f"weak tx: SsbTxStreamer {len(out[device])} blocks of {block} mic "
          f"samples to {4 * block} at {fs_da} Hz; {device} vs CPU max_rel "
          f"{worst:.3e} (bar {TX_TOL}); ms per block {1e3 * secs[device] / n:.3f}"
          f" on {device}, {1e3 * secs['cpu'] / n:.3f} on the CPU "
          f"[{dev['smi']}]")
    if len(out[device]) != TX_BLOCKS or worst > TX_TOL:
        raise AssertionError("weak: the transmit streamer disagrees with its "
                             "CPU run")


# ---- the receivers from CUDA graphs: phase 21 ---------------------------

def afc_shard_params(tiny: bool = False):
    """tests/test_torch_sharded.py's "afc-coherent" configuration over
    SHARD_D shards (96 kHz IQ, fft1 8192, 262,144 samples and 16,384
    baseband samples per step, the coherent AFC); ``tiny`` cuts it to fft1
    256 for a rehearsal on the CPU."""
    from linrad_tpu_torch import RxParams
    cut = (dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6)
           if tiny else {})
    return RxParams(first_fft_bandwidth=30.0, mix1_bandwidth_reduction_n=4,
                    agc_enable=False, afc_enable=True, filter_low_hz=-150.0,
                    filter_high_hz=150.0, shards=SHARD_D, **cut)


def drifting_input(geo, steps: int, seed: int = 0) -> np.ndarray:
    """tests/test_torch_sharded.py's AFC input: a carrier at
    AFC_SHARD_HZ drifting 2 Hz/s, complex Gaussian noise."""
    fs = geo.rx_ad_speed
    n = geo.samples_per_step * steps
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    return (0.3 * np.exp(2j * np.pi * (AFC_SHARD_HZ * t + t * t))
            + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def same_outputs(outs: list, ref: list, label: str) -> None:
    """Every RxOutputs field of every step equal bit for bit."""
    if len(outs) != len(ref):
        raise AssertionError(f"{label}: {len(outs)} steps against "
                             f"{len(ref)}")
    for i, (a, b) in enumerate(zip(outs, ref)):
        equal_outputs(a, b, f"{label} step {i}")


def capture_s(graph) -> float:
    """Seconds of a GraphedStep's capture: its ``graph.capture`` span."""
    from linrad_tpu_torch.utils import trace
    return trace.seconds("graph.capture", graph.trace_id)


def graph_report(rx, label: str, dev: dict) -> None:
    """Capture seconds and graph pool bytes of each of a receiver's
    graphs, and its replays."""
    on_card = rx.device.type == "cuda"
    print(f"graphed {label}: " + "; ".join(
        f"structure {name}: {g.replays} replays, {g.kernels} fused_fft1 "
        f"node(s), capture {capture_s(g):.3f} s, graph pool "
        f"{graph_pool_bytes(g.graph) if on_card else 0} bytes"
        for name, g in rx.graphs.items()) + f" [{dev['smi']}]")


def phase_graphed(dev: dict, device="cuda", tiny: bool = False,
                  k_sub: int = MULTI_K, scan_interval: int | None = None,
                  **eme_overrides) -> int:
    """Phase 21: Receiver, MultiReceiver and the one-card sharded classes
    replaying their step from CUDA graphs, held against the same classes
    with graphed=False, every RxOutputs field bit for bit.  Returns the
    kernel's launches over the graphed runs, as the receivers count them.
    ``device="cpu"`` with ``tiny=True`` (and the EME cut in
    ``eme_overrides``) rehearses the control flow: graphed=True there runs
    the graphs' bodies eagerly."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.parallel import (ShardedBatchRunner,
                                           ShardedMultiReceiver,
                                           ShardedReceiver)
    from linrad_tpu_torch.pipeline.checkpoint import (load_receiver,
                                                      save_receiver)
    from linrad_tpu_torch.pipeline.receiver import Receiver
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    graphed = None if on_card else True
    launches = 0

    # (a) the flagship through the kernel, phase 4's input
    p = flagship_params(tiny=tiny, fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = make_input(geo)
    flag = Receiver(p, device=device, graphed=graphed, recorded=recorded_fft1)
    flag.tune(TUNE_HZ)
    wrapper = fused_fft1.launches
    outs = list(flag.run(iq))
    wrapper = fused_fft1.launches - wrapper
    same_outputs(outs, run_rx(p, iq, device, graphed=False),
                 "graphed flagship")
    print(f"graphed flagship: {len(outs)} steps, every RxOutputs field "
          f"bit-equal to graphed=False; {flag.kernels_per_replay} fused_fft1 "
          f"node per replay, launches {flag.kernel_launches} (wrapper calls "
          f"{wrapper})")
    graph_report(flag, "flagship", dev)
    if not flag.graphed or (on_card and (
            flag.kernels_per_replay != 1 or flag.kernel_launches != STEPS
            or wrapper != 0)):
        raise AssertionError("graphed flagship: expected one kernel launch "
                             "per step, all from replays")
    launches += flag.kernel_launches

    # (b) the EME configuration through the AFC's lock, phase 6's input
    pe = eme_params("pallas", **eme_overrides)
    ge = derive_geometry(pe)
    iqe = make_eme_input(ge, EME_STEPS + EME_TIME_STEPS)
    eme, g_outs, g_track, eme_launches = run_eme(pe, iqe, device, graphed)
    eme_eager, e_outs, e_track, _ = run_eme(pe, iqe, device, graphed=False)
    for i, (a, b) in enumerate(zip(g_track, e_track)):
        if a[0] != b[0] or a[1] != b[1] or not np.array_equal(a[2], b[2]):
            raise AssertionError(f"graphed eme step {i}: AFC trajectory "
                                 f"{a} != {b}")
    same_outputs(g_outs, e_outs, "graphed eme")
    replays = {name: g.replays for name, g in eme.graphs.items()}
    print(f"graphed eme: {EME_STEPS} steps, AFC status per step "
          f"{[t[0] for t in g_track]} and freq_hz equal to graphed=False's "
          f"in every step, every RxOutputs field bit-equal; replays per "
          f"structure {replays}; launches {eme_launches}; host reads "
          f"{eme.control.host_reads / EME_STEPS:.1f} per step")
    graph_report(eme, "eme", dev)
    if min(replays.values()) < 1 or set(replays) != {"bin", "coherent"}:
        raise AssertionError("graphed eme: a structure's graph never ran")
    if on_card and (eme.kernels_per_replay != 1
                    or eme_launches != EME_STEPS):
        raise AssertionError("graphed eme: expected one kernel launch per "
                             "step")
    launches += eme_launches

    # (c) checkpoint and resume through the graphed Receiver: saved as
    # phase 11 saves, resumed against the eager run of (b)
    s = ge.samples_per_step
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "eme.npz")
        first = Receiver(pe, device=device, graphed=graphed,
                         recorded=recorded_fft1)
        first.tune(EME_TUNE_HZ)
        saved_at = None
        for i in range(EME_STEPS - 3):
            first.process_block(iqe[i * s:(i + 1) * s])
            if first.afc.status in (2, 3):
                save_receiver(path, first)
                saved_at = i
                break
        if saved_at is None:
            raise AssertionError("graphed checkpoint: the AFC did not lock "
                                 "in time to resume")
        resumed = load_receiver(path, device=device, graphed=graphed,
                                recorded=recorded_fft1)
        for i in range(saved_at + 1, EME_STEPS):
            out = resumed.process_block(iqe[i * s:(i + 1) * s])
            equal_outputs(out, e_outs[i], f"graphed resume step {i}")
            if (resumed.afc.status, resumed.afc.freq_hz) != e_track[i][:2]:
                raise AssertionError(f"graphed resume step {i}: the AFC "
                                     f"went another way")
    print(f"graphed checkpoint: eme saved by a graphed Receiver after step "
          f"{saved_at} (status {g_track[saved_at][0]}), loaded into a "
          f"graphed Receiver: steps {saved_at + 1}-{EME_STEPS - 1} bit-equal "
          f"to the graphed=False run, AFC status and frequency equal")
    launches += first.kernel_launches + resumed.kernel_launches

    # (d) the 24 sub-receivers with phase 8's spur manager, phase 8's input
    pm = multi_params("pallas", tiny)
    gm = derive_geometry(pm)
    dials = multi_dials(gm, k_sub)
    iqm = make_input(gm, seed=5, steps=MULTI_STEPS + MULTI_TIME_STEPS,
                     tones=dials, tone_amplitude=MULTI_TONE_AMPLITUDE,
                     spur=(MULTI_SPUR_HZ, MULTI_SPUR_AMPLITUDE))
    multi, ctl, m_outs, m_slots, multi_launches = run_multi(
        pm, k_sub, dials, iqm, MULTI_STEPS, device, scan_interval, graphed)
    _, _, m_ref, m_ref_slots, _ = run_multi(pm, k_sub, dials, iqm,
                                            MULTI_STEPS, device,
                                            scan_interval, graphed=False)
    for i, (a, b) in enumerate(zip(m_slots, m_ref_slots)):
        if not np.array_equal(a, b):
            raise AssertionError(f"graphed multi step {i}: spur slots {a} "
                                 f"!= {b}")
    same_outputs(m_outs, m_ref, "graphed multi")
    print(f"graphed multi: MultiReceiver K={k_sub}, {MULTI_STEPS} steps with "
          f"the dial-protecting spur manager every {ctl.spur_scan_interval} "
          f"step(s): spur slots equal and every RxOutputs field bit-equal "
          f"to graphed=False; launches {multi_launches}; host reads "
          f"{ctl.host_reads / MULTI_STEPS:.1f} per step")
    graph_report(multi, f"multi K={k_sub}", dev)
    if on_card and (multi.kernels_per_replay != 1
                    or multi_launches != MULTI_STEPS):
        raise AssertionError("graphed multi: expected one kernel launch per "
                             "step")
    launches += multi_launches

    # (e) the sharded classes with every shard on the card
    card = [device] * SHARD_D
    pa = afc_shard_params(tiny)
    ga = derive_geometry(pa)
    iqa = drifting_input(ga, AFC_SHARD_STEPS)
    runs = {}
    for g in (graphed, False):
        rx = ShardedReceiver(pa, card, graphed=g)
        rx.tune(AFC_SHARD_HZ)
        outs, track = [], []
        for out in rx.run(iqa):
            outs.append(out)
            track.append((rx.control.afc.status, rx._tune_bin.tolist()))
        runs[g] = (rx, outs, track)
    sh, sh_outs, sh_track = runs[graphed]
    if sh_track != runs[False][2]:
        raise AssertionError(f"graphed sharded: AFC trajectory {sh_track} "
                             f"!= {runs[False][2]}")
    same_outputs(sh_outs, runs[False][1], "graphed sharded")
    replays = {name: g.replays for name, g in sh.graphs.items()}
    print(f"graphed sharded: ShardedReceiver over {card}, the coherent AFC "
          f"configuration ({ga.samples_per_step} samples, "
          f"{ga.baseband_samples_per_step} baseband samples a step), "
          f"{len(sh_outs)} steps: AFC status per step "
          f"{[t[0] for t in sh_track]} equal to graphed=False's, every "
          f"RxOutputs field bit-equal; replays per structure {replays}")
    graph_report(sh, "sharded", dev)
    if not sh.graphed or min(replays.values()) < 1:
        raise AssertionError("graphed sharded: a structure's graph never "
                             "ran")

    ps = dataclasses.replace(flagship_params(tiny=tiny), shards=SHARD_D)
    gs = derive_geometry(ps)
    dial = shard_dial(gs)
    iqs = make_input(gs, steps=SHARD_STEPS)
    br = ShardedBatchRunner(ps, k_steps=SHARD_K, outputs=("audio", "baseb"),
                            devices=card, graphed=graphed)
    br.tune(dial)
    got = br.process(iqs)
    streamed = run_sharded(ps, iqs, card, dial, graphed=False)
    for f in ("audio", "baseb"):
        if not np.array_equal(got[f], torch.cat(
                [getattr(o, f) for o in streamed]).cpu().numpy()):
            raise AssertionError(f"graphed sharded batch: {f} differs from "
                                 f"the streamed receiver")
    dials3 = multi_dials(gs, SHARD_SUB)
    iq3 = make_input(gs, seed=2, steps=SHARD_SUB_STEPS, tones=dials3,
                     tone_amplitude=MULTI_TONE_AMPLITUDE)
    sub = {}
    for g in (graphed, False):
        mx = ShardedMultiReceiver(ps, SHARD_SUB, card, graphed=g)
        for k, f in enumerate(dials3):
            mx.tune_subch(k, f)
        sub[g] = list(mx.run(iq3))
    same_outputs(sub[graphed], sub[False], "graphed sharded multi")
    print(f"graphed sharded: ShardedBatchRunner(k_steps={SHARD_K}) from its "
          f"graph ({br.graphed.replays} replays) over {SHARD_STEPS} steps "
          f"bit-equal to the eager streamed ShardedReceiver; "
          f"ShardedMultiReceiver K={SHARD_SUB} over {SHARD_SUB_STEPS} steps "
          f"bit-equal to graphed=False")
    if br.graphed is None:
        raise AssertionError("graphed sharded batch: not captured")

    if on_card:
        phase_graphed_timing(dev, flag, eme, eme_eager, iqe, pm, dials, iqm)
    print(f"graphed: phase 21 in {time.perf_counter() - t0:.1f} s")
    return launches



def phase_graphed_timing(dev: dict, flag, eme, eme_eager, iqe: np.ndarray,
                         pm, dials, iqm: np.ndarray) -> None:
    """ms per step of the graphed and the eager receivers in turns, whole
    process_block loops between CUDA events (the graphed step's copies of
    its outputs, the AFC's read and the host's control included): the
    flagship, the EME configuration (and its graph without the AFC's read
    and the copies: ``Receiver._advance``) and MultiReceiver at K = 1 and
    K = MULTI_K.  Every receiver is made (captured) first; then one pass
    of torch.profiler over graphed flagship steps and an eager loop, the
    warm-up after which ``--regimes`` saw the fast regime.  Each turn's
    number is printed, so that two regimes show as two numbers."""
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver, Receiver

    def on_card(x: np.ndarray, s: int, first: int, n: int) -> list:
        return [torch.from_numpy(x[i * s:(i + 1) * s]).cuda()
                for i in range(first, first + n)]

    flag_eager = Receiver(flag.params, device=flag.device, graphed=False)
    flag_eager.tune(TUNE_HZ)
    multis = {}
    for k in (1, MULTI_K):
        for g in (None, False):
            rx = MultiReceiver(pm, k, graphed=g, recorded=recorded_fft1)
            for j in range(k):
                rx.tune_subch(j, dials[j])
            multis[("graphed" if g is None else "eager", k)] = rx
    fb = on_card(make_input(flag.geo, seed=1), flag.geo.samples_per_step, 0,
                 STEPS)
    eb = on_card(iqe, eme.geo.samples_per_step, EME_STEPS, EME_TIME_STEPS)
    mb = on_card(iqm, multis[("graphed", 1)].geo.samples_per_step,
                 MULTI_STEPS, MULTI_TIME_STEPS)

    def loop(rx, blocks, bare=False):
        step = rx._advance if bare else rx.process_block

        def fn():
            for b in blocks:
                step(b)
        return fn

    # a graphed step on device input makes no host synchronisation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flag.process_block(fb[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the warm-up: the profiler's pass, then an eager loop of each
    prof = profile_call(loop(flag, fb))
    print(f"graphed timing: a graphed flagship Receiver step on device "
          f"input makes no host synchronisation; under torch.profiler "
          f"{prof['ops'] // STEPS} device kernels and copies and "
          f"{prof['busy_ms'] / STEPS:.3f} ms of device time per step in "
          f"{prof['wall_ms'] / STEPS:.3f} ms of wall (device time / wall "
          f"{prof['busy_ms'] / prof['wall_ms']:.4f}) [{dev['smi']}]")
    loop(flag_eager, fb[:2])()
    loop(eme_eager, eb[:2])()
    for rx in multis.values():
        loop(rx, mb[:2])()

    def turns(label: str, fns: dict, order: tuple, n: int, samples: int
              ) -> dict:
        times: dict = {}
        for name in order:
            t0 = time.perf_counter()
            ms = timed_ms(fns[name]) / n
            host = 1e3 * (time.perf_counter() - t0) / n
            times.setdefault(name, []).append(ms)
            print(f"graphed timing {label} {name}: {ms:.3f} ms/step (CUDA "
                  f"events around {n} steps), host {host:.3f} ms/step, "
                  f"{samples / ms / 1e3:.3f} complex Msamples/s "
                  f"[{dev['smi']}]")
        print(f"graphed timing {label}: ms/step " + "; ".join(
            f"{name} {min(v):.3f}-{max(v):.3f}" for name, v in times.items()))
        return times

    def ratio(t: dict, a: str, b: str) -> float:
        return sum(t[a]) / sum(t[b])

    t = turns("flagship", {"graphed": loop(flag, fb),
                           "eager": loop(flag_eager, fb)},
              ("graphed", "eager", "eager", "graphed"), STEPS,
              flag.geo.samples_per_step)
    print(f"graphed timing flagship: eager / graphed "
          f"{ratio(t, 'eager', 'graphed'):.2f}")
    reads = eme.control.host_reads
    t = turns("eme", {"graphed": loop(eme, eb),
                      "graphed, no AFC read": loop(eme, eb, bare=True),
                      "eager": loop(eme_eager, eb)},
              ("graphed", "graphed, no AFC read", "eager", "eager",
               "graphed, no AFC read", "graphed"), EME_TIME_STEPS,
              eme.geo.samples_per_step)
    reads = (eme.control.host_reads - reads) / (2 * EME_TIME_STEPS)
    cost = (sum(t["graphed"]) - sum(t["graphed, no AFC read"])) / 2
    print(f"graphed timing eme: eager / graphed "
          f"{ratio(t, 'eager', 'graphed'):.2f}; {reads:.0f} host read per "
          f"Receiver step; the AFC's read, the control and the copies of the "
          f"outputs cost {cost:.3f} ms/step over the graph alone")
    fns = {f"{mode} K={k}": loop(rx, mb) for (mode, k), rx in multis.items()}
    t = turns("multi", fns,
              ("graphed K=1", f"graphed K={MULTI_K}", f"eager K={MULTI_K}",
               "eager K=1", "eager K=1", f"eager K={MULTI_K}",
               f"graphed K={MULTI_K}", "graphed K=1"), MULTI_TIME_STEPS,
              multis[("graphed", 1)].geo.samples_per_step)
    k24 = f"K={MULTI_K}"
    print(f"graphed timing multi: K={MULTI_K} / K=1 graphed "
          f"{ratio(t, f'graphed {k24}', 'graphed K=1'):.3f}, eager "
          f"{ratio(t, f'eager {k24}', 'eager K=1'):.3f}; eager / graphed "
          f"K=1 {ratio(t, 'eager K=1', 'graphed K=1'):.2f}, {k24} "
          f"{ratio(t, f'eager {k24}', f'graphed {k24}'):.2f}")
    for (mode, k), rx in multis.items():
        if mode == "graphed":
            graph_report(rx, f"multi K={k} (timing)", dev)


# ---- this slice: every Linrad mode on the card, phases 22 and 23 -------

def preset_startup(ref0, geo) -> tuple[int, int]:
    """(fill, head) in step 0's baseband samples of a reference run: the
    pipeline's fill (the baseband under PRESET_FILL_LEVEL of the step's
    maximum: roundoff, which the AGC takes to full scale on both sides,
    left out), then the AGC's start-up, PRESET_START_S seconds."""
    bb = ref0.baseb.detach().abs().amax(dim=-1).cpu()
    fill = int(torch.nonzero(bb >= PRESET_FILL_LEVEL * bb.max())[0])
    return fill, fill + int(PRESET_START_S * geo.baseband_sampling_speed)


def compare_presets(outs: list, ref: list, geo, label: str, what: str,
                    tol: dict) -> dict:
    """A preset's run against a reference run: blanker counts and the
    liminfo sign pattern exact; every float field of every step within
    ``tol`` (CHAIN_TOL_OTHER for a field it does not name), but step 0's
    audio and agc_gain, held to PRESET_START_TOL with the pipeline's fill
    left out (ROADMAP queue 3: the AGC's start-up, and in FM the
    discriminator's output on the fill's roundoff, which the AGC's peak
    hold keeps through the step); their start-up and the rest of the step
    are printed apart.  Returns the worst max_rel per field."""
    fill, head = preset_startup(ref[0], geo)
    worst, failed = {}, []

    def note(k: str, e: float, bar: float, i: int) -> None:
        worst[k] = max(worst.get(k, 0.0), e)
        if e > bar:
            failed.append(f"step {i} {k}: max_rel {e} > {bar}")

    for i, (a, b) in enumerate(zip(outs, ref)):
        for f in dataclasses.fields(a):
            k = f.name
            va, vb = getattr(a, k), getattr(b, k)
            if (va is None) != (vb is None):
                failed.append(f"step {i} {k}: present on one side only")
            if va is None or vb is None:
                continue
            va, vb = va.detach().cpu(), vb.detach().cpu()
            if k in ("blanker_fitted", "blanker_cleared"):
                if int(va) != int(vb):
                    failed.append(f"step {i} {k}: {int(va)} != {int(vb)}")
                continue
            if k == "liminfo" and not torch.equal(torch.sign(va),
                                                  torch.sign(vb)):
                failed.append(f"step {i}: liminfo sign pattern differs")
            if i == 0 and k in ("audio", "agc_gain"):
                note(f"{k} start-up", max_rel(va[fill:head], vb[fill:head]),
                     PRESET_START_TOL, i)
                if head < va.shape[0]:
                    note(f"{k} rest of step 0", max_rel(va[head:], vb[head:]),
                         PRESET_START_TOL, i)
                continue
            note(k, max_rel(va, vb), tol.get(k, CHAIN_TOL_OTHER), i)
    print(f"{label}{what}: " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in worst.items())
          + f"; counts and liminfo signs exact (bars {tol}, others "
          f"{CHAIN_TOL_OTHER}; step 0's audio and agc_gain "
          f"{PRESET_START_TOL}, the start-up samples {fill}-{head}, the "
          f"{fill} before it left out)")
    if failed:
        raise AssertionError(f"{label}{what}: " + "; ".join(failed))
    return worst


def run_preset(p, iq: np.ndarray, device, graphed, steps: int) -> tuple:
    """A Receiver of ``p`` on ``device`` tuned to PRESET_DIAL_HZ over the
    first ``steps`` steps of iq: (receiver, outputs, AFC status per
    step)."""
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(p, device=device, graphed=graphed, recorded=recorded_fft1)
    rx.tune(PRESET_DIAL_HZ)
    s = rx.geo.samples_per_step
    outs, status = [], []
    for i in range(steps):
        outs.append(rx.process_block(iq[i * s:(i + 1) * s]))
        status.append(rx.afc.status if rx.afc else None)
    if rx.device.type == "cuda":
        torch.cuda.synchronize()
    return rx, outs, status


def phase_presets(dev: dict, device="cuda", modes=None) -> int:
    """Phase 22: the nine presets at their published widths, each on the
    input that fits its mode (io/modeinput.py), through the Receiver a
    user makes (graphed on a card).  Returns the kernel's launches over
    the graphed "pallas" runs.  ``device="cpu"`` with a few ``modes``
    rehearses the control flow (graphed=True runs the graphs' bodies
    eagerly; no timing)."""
    from linrad_tpu_torch import RxMode, derive_geometry, preset
    from linrad_tpu_torch.io.modeinput import mode_input
    from linrad_tpu_torch.ops import mix1 as mx
    from linrad_tpu_torch.ops import sellim as sl
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    graphed = None if on_card else True
    launches, table = 0, []
    for mode in modes or list(RxMode):
        mode = RxMode[mode] if isinstance(mode, str) else RxMode(mode)
        label = f"presets {mode.name}: "
        p = preset(mode)
        geo = derive_geometry(p)
        steps = PRESET_AFC_STEPS if p.afc_enable else PRESET_STEPS
        iq = mode_input(mode, geo, steps + PRESET_TIME_STEPS, PRESET_DIAL_HZ)
        captured = mx.ramp_count.captured
        g, g_outs, g_status = run_preset(p, iq, device, graphed, steps)
        # each graph records one mix1_ramp call, which each replay runs
        ramps = (mx.ramp_count.captured - captured,
                 sum(x.replays for x in g.graphs.values()))
        if on_card and ramps[0] != len(g.graphs):
            raise AssertionError(f"{label}mix1_ramp: {ramps[0]} calls "
                                 f"recorded in {len(g.graphs)} graphs")
        eager = []
        tapers = record_calls(sl, "sellim_taper", lambda: eager.append(
            run_preset(p, iq, device, False, steps)))
        e, e_outs, e_status = eager[0]
        print(f"{label}sellim_taper: passes its inputs need per step "
              f"{[taper_passes(*a) for a in tapers] or 'no call'}, closed "
              f"form's precondition holds "
              f"{[sl.taper_closed_form_holds(*a) for a in tapers]}")
        same_outputs(g_outs, e_outs, f"{label}graph against eager")
        if g_status != e_status:
            raise AssertionError(f"{label}AFC {g_status} != {e_status}")
        print(f"{label}fft1 {geo.fft1_size}, fft2 "
              f"{geo.fft2_size if geo.second_fft_enable else None}, "
              f"{geo.samples_per_step} samples and "
              f"{geo.baseband_samples_per_step} baseband samples at "
              f"{geo.baseband_sampling_speed:g} Hz a step, demod "
              f"{p.demod.name}; {steps} steps graphed "
              f"({', '.join(f'{n} {x.replays}' for n, x in g.graphs.items())}"
              f" replays) bit-equal to graphed=False; AFC status per step "
              f"{g_status}; mix1_ramp {ramps[0]} call(s) recorded, "
              f"{ramps[1] if on_card else 0} launches by the replays "
              f"(L {geo.fftx_frames_per_step * geo.mix1_new_points})")
        _, c_outs, c_status = run_preset(p, iq, "cpu", False, steps)
        if c_status != g_status:
            raise AssertionError(f"{label}AFC on the CPU {c_status} != "
                                 f"{g_status}")
        compare_presets(g_outs, c_outs, geo, label,
                        f"{device} against the CPU", PRESET_TOL)
        if p.afc_enable and (g_status[-1] not in (2, 3)
                             or g.graphs["coherent"].replays < 1):
            raise AssertionError(f"{label}the AFC did not take the "
                                 f"per-frame tuning")
        if geo.fft1_size <= PALLAS_MAX_N:
            pp = dataclasses.replace(p, fft1_variant="pallas")
            k, k_outs, _ = run_preset(pp, iq, device, graphed, steps)
            _, ke_outs, _ = run_preset(pp, iq, device, False, steps)
            same_outputs(k_outs, ke_outs, f"{label}pallas graph against "
                                          f"eager")
            compare_presets(k_outs, g_outs, geo, label,
                            " pallas against torch.fft", CHAIN_TOL)
            shape = (geo.fft1_frames_per_step, geo.fft1_size, geo.channels)
            print(f"{label}pallas: fused_fft1 at {shape}, "
                  f"{k.kernels_per_replay} node per replay, launches "
                  f"{k.kernel_launches} in {steps} steps")
            if on_card and (k.kernels_per_replay != 1
                            or k.kernel_launches != steps):
                raise AssertionError(f"{label}pallas: expected one kernel "
                                     f"launch per step")
            launches += k.kernel_launches
            graph_report(k, f"{mode.name} pallas", dev)
        if on_card:
            table.append(preset_timing(dev, mode.name, g, e, iq, steps))
        graph_report(g, mode.name, dev)
    for row in table:
        print("presets table: " + row)
    print(f"presets: phase 22 in {time.perf_counter() - t0:.1f} s")
    return launches


def preset_timing(dev: dict, name: str, g, e, iq: np.ndarray,
                  first: int) -> str:
    """ms per step of a preset's graphed and eager Receiver in turns, whole
    process_block loops on device input (the AFC's read and the control
    included) after the warm-up that ends in the fast replay regime (a
    profiler pass over the graphed steps, then an eager loop); kernels
    per step of both from torch.profiler."""
    s = g.geo.samples_per_step
    blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
              for i in range(first, first + PRESET_TIME_STEPS)]

    def loop(rx):
        def fn():
            for b in blocks:
                rx.process_block(b)
        return fn

    n = PRESET_TIME_STEPS
    prof = profile_call(loop(g))
    prof_e = profile_call(loop(e))
    times: dict = {}
    for which in ("graphed", "eager", "eager", "graphed"):
        ms = timed_ms(loop(g if which == "graphed" else e)) / n
        times.setdefault(which, []).append(ms)
        print(f"presets timing {name} {which}: {ms:.3f} ms/step (CUDA "
              f"events around {n} steps), {s / ms / 1e3:.3f} complex "
              f"Msamples/s [{dev['smi']}]")
    gk, ek = prof["ops"] / n, prof_e["ops"] / n
    print(f"presets timing {name}: device kernels and copies per step "
          f"(torch.profiler) graphed {gk:.0f}, eager {ek:.0f}; device time "
          f"per graphed step {prof['busy_ms'] / n:.3f} ms in "
          f"{prof['wall_ms'] / n:.3f} ms of wall; eager / graphed "
          f"{sum(times['eager']) / sum(times['graphed']):.2f}")
    gr, er = times["graphed"], times["eager"]
    return (f"{name}: graphed {min(gr):.3f}-{max(gr):.3f} ms/step "
            f"({s / max(gr) / 1e3:.3f}-{s / min(gr) / 1e3:.3f} Msamples/s), "
            f"eager {min(er):.3f}-{max(er):.3f} ms/step "
            f"({s / max(er) / 1e3:.3f}-{s / min(er) / 1e3:.3f}), kernels "
            f"per step graphed {gk:.0f}, eager {ek:.0f} [{dev['smi']}]")


def radar_mode_fronts(p, iq: np.ndarray, steps: int, device, graphed,
                      recorded=None) -> tuple:
    """preset(RADAR)'s receiver on ``device`` and its radar front end
    feeding a tracker over ``steps`` steps of iq: (front, tracker, the
    front's outputs per step)."""
    from linrad_tpu_torch.pipeline.receiver import Receiver
    from linrad_tpu_torch.weak.radar import (RadarFront, RadarParams,
                                             RadarTracker)
    rx = Receiver(p, device=device, graphed=False)
    geo = rx.geo
    front = RadarFront.of_receiver(rx, graphed=graphed, recorded=recorded)
    tracker = RadarTracker(
        n_bins=geo.fft1_size,
        frame_time_s=geo.fft1_new_points / geo.timf1_sampling_speed,
        bin_hz=geo.timf1_sampling_speed / geo.fft1_size,
        params=RadarParams(time=2.0, lock_after=500), device=device)
    s = geo.samples_per_step
    outs = []
    for i in range(steps):
        out = front(iq[i * s:(i + 1) * s])
        tracker.feed(out[0], stats=out[1:])
        outs.append(out)
    return front, tracker, outs


def tracker_view(t) -> tuple:
    return (t.locked, t.pulse_sep, t.pulse_bin, t.lines, t.first_bin,
            t.last_bin, t.update_cnt, t.echo_peak())


def phase_radar_mode(dev: dict, device="cuda") -> int:
    """Phase 23: the RADAR mode's own device path.  preset(RADAR) with the
    fused fft1; its receiver's front end (RadarFront: fft1, the frames'
    power and frame_pulse_stats, one CUDA graph per step) feeds a
    RadarTracker on the card over RADAR_MODE_STEPS steps of a pulse train
    with its echo.  Held: the graph against the eager front, every output
    bit for bit; a tracker fed the eager front's power alone (its own
    frame_pulse_stats on the card) decides the same; lock, pulse
    separation and echo range equal to the same run on the CPU; one kernel
    launch of fused_fft1 and one of radar_stats per replay.  Then ms per
    step of the graphed and eager front in turns, the kernels of a replay
    and of one display update (``_accumulate``, kept eager).  Returns the
    graphed front's launches of fused_fft1 and of radar_stats over the
    RADAR_MODE_STEPS steps."""
    from linrad_tpu_torch import RxMode, derive_geometry, preset
    from linrad_tpu_torch.io.modeinput import radar_iq
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    from linrad_tpu_torch.weak.radar import (RadarTracker, _accumulate,
                                             stats_count)
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    p = preset(RxMode.RADAR, fft1_variant="pallas")
    geo = derive_geometry(p)
    iq = radar_iq(geo, RADAR_MODE_STEPS + RADAR_TIME_STEPS,
                  tx_bin=RADAR_TX_BIN, pulse_sep=RADAR_SEP,
                  pulse_width=RADAR_WIDTH, echo_delay=RADAR_DELAY,
                  doppler_bins=RADAR_DOPPLER)[:, None]
    n = RADAR_MODE_STEPS
    captured = stats_count.captured
    front, tg, g_outs = radar_mode_fronts(p, iq, n, device,
                                          None if on_card else True,
                                          recorded_fft1)
    captured = stats_count.captured - captured
    wrapper = fused_fft1.launches
    stats_calls = stats_count.launches
    eager, te, e_outs = radar_mode_fronts(p, iq, n, device, False)
    wrapper = fused_fft1.launches - wrapper
    stats_calls = stats_count.launches - stats_calls
    for i, (a, b) in enumerate(zip(g_outs, e_outs)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"radar mode step {i}: the graph's power "
                                 f"or statistics differ from the eager "
                                 f"front's")
    own = RadarTracker(n_bins=tg.n_bins, frame_time_s=tg.frame_time_s,
                       bin_hz=tg.bin_hz, params=tg.params, device=device)
    for out in e_outs:
        own.feed(out[0])            # a CUDA tensor, statistics of its own
    _, tc, c_outs = radar_mode_fronts(p, iq, n, "cpu", False)
    views = [tracker_view(t) for t in (tg, te, own, tc)]
    rel_pw = max(max_rel(a[0].cpu(), b[0]) for a, b in zip(g_outs, c_outs))
    rel_avg = max_rel(torch.from_numpy(tg.average),
                      torch.from_numpy(tc.average))
    line, off, dopp = tg.echo_peak()
    print(f"radar mode: preset(RADAR) with the fused fft1 at "
          f"({geo.fft1_frames_per_step}, {geo.fft1_size}, {geo.channels}), "
          f"{n} steps of a pulse train every {RADAR_SEP} frames with its "
          f"echo {RADAR_DELAY} frames later, {RADAR_DOPPLER} bins off: "
          f"graph bit-equal to the eager front in every step; tracker "
          f"locked {tg.locked}, pulse_sep {tg.pulse_sep}, pulse_bin "
          f"{tg.pulse_bin}, {tg.update_cnt} display updates, echo line "
          f"{line}, bin offset {off}, doppler {dopp} Hz, range "
          f"{tg.line_to_range_m(line):.0f} m; the same on the eager front, "
          f"on the card's power fed as a tensor and on the CPU; power "
          f"max_rel against the CPU {rel_pw:.2e}, display {rel_avg:.2e}")
    if len(set(views)) != 1 or not tg.locked or tg.pulse_sep != RADAR_SEP \
            or tg.pulse_bin != RADAR_TX_BIN or abs(line - RADAR_DELAY) > 1 \
            or off != RADAR_DOPPLER:
        raise AssertionError(f"radar mode: the trackers decided {views}")
    if rel_pw > 1e-5 or rel_avg > 1e-5:
        raise AssertionError("radar mode: power or display off the CPU's")
    launches = front.kernel_launches
    stats_launches = captured * front.graph.replays
    print(f"radar mode: fused_fft1 {front.graph.kernels} node per replay, "
          f"launches {launches} in {n} replays; the eager front's wrapper "
          f"calls {wrapper}; radar_stats {captured} node per replay, "
          f"launches {stats_launches}; the eager front's {stats_calls}")
    if on_card and (front.graph.kernels != 1 or launches != n
                    or wrapper != n or captured != 1 or stats_launches != n
                    or stats_calls != n):
        raise AssertionError("radar mode: expected one launch of each "
                             "kernel per step")
    if on_card:
        s = geo.samples_per_step
        blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
                  for i in range(n, n + RADAR_TIME_STEPS)]

        def loop(f):
            def fn():
                for b in blocks:
                    f(b)
            return fn

        prof = profile_call(loop(front))
        prof_e = profile_call(loop(eager))
        times: dict = {}
        for which in ("graphed", "eager", "eager", "graphed"):
            ms = timed_ms(loop(front if which == "graphed" else eager)) \
                / RADAR_TIME_STEPS
            times.setdefault(which, []).append(ms)
            print(f"radar mode timing {which}: {ms:.3f} ms/step (CUDA "
                  f"events around {RADAR_TIME_STEPS} steps), "
                  f"{s / ms / 1e3:.3f} complex Msamples/s [{dev['smi']}]")
        hist = torch.from_numpy(np.concatenate(tg._hist_pw)).cuda()
        avg = tg._avg.clone()

        def updates():
            for _ in range(RADAR_UPDATES):
                _accumulate(avg, hist, 0, tg.decayfac, tg.lines,
                            tg.first_bin, tg.last_bin)

        updates()
        acc = profile_call(updates)
        acc_ms = timed_ms(updates) / RADAR_UPDATES
        print(f"radar mode timing: device kernels and copies per step "
              f"(torch.profiler) graphed {prof['ops'] / RADAR_TIME_STEPS:.0f}"
              f" (the front's replay and its output copies) in "
              f"{prof['busy_ms'] / RADAR_TIME_STEPS:.3f} ms of device time, "
              f"eager {prof_e['ops'] / RADAR_TIME_STEPS:.0f}; one display update "
              f"(_accumulate, eager) {acc['ops'] / RADAR_UPDATES:g} "
              f"kernel(s), {acc['busy_ms'] / RADAR_UPDATES:.4f} ms of device "
              f"time, {acc_ms:.4f} ms between CUDA events (over "
              f"{RADAR_UPDATES} updates); eager / graphed "
              f"{sum(times['eager']) / sum(times['graphed']):.2f} "
              f"[{dev['smi']}]")
        graph_report_one(front.graph, "radar mode", dev)
    print(f"radar mode: phase 23 in {time.perf_counter() - t0:.1f} s")
    return launches, stats_launches


def phase_fft2_step(dev: dict, device="cuda", tiny: bool = False,
                    steps: int = 3) -> None:
    """fft2_step at the flagship geometry: three steps of seeded noise
    bit-equal to fft2_transform then fft2_power_update, and to itself
    with TF32 switched on by the caller; make_tail's carry tail on the
    card.  No fused_fft1 launch."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops import fft2, framing
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    t0 = time.perf_counter()
    geo = derive_geometry(flagship_params(tiny=tiny))
    rng = np.random.default_rng(5)
    shape = (geo.samples_per_step, geo.channels)

    def noise(scale):
        return torch.from_numpy((scale * (rng.normal(size=shape) + 1j
                                          * rng.normal(size=shape))
                                 ).astype(np.complex64)).to(device)

    tables = fft2.FFT2Tables.create(geo, device)
    tail = framing.make_tail(geo.fft2_size, geo.fft2_new_points,
                             (geo.channels,), device=device)
    if tail.shape != fft2.FFT2State.create(geo, device).tail.shape \
            or tail.device.type != torch.device(device).type \
            or torch.count_nonzero(tail).item():
        raise AssertionError(f"fft2_step: make_tail gave {tail.shape} on "
                             f"{tail.device}")
    whole = parts = fft2.FFT2State.create(geo, device)
    fused_fft1.launches = 0
    saved = torch.backends.cuda.matmul.allow_tf32
    for step in range(steps):
        weak, strong = noise(1.0), noise(5.0)
        torch.backends.cuda.matmul.allow_tf32 = step == steps - 1
        try:
            whole, spec, power = fft2.fft2_step(geo, tables, whole, weak,
                                                strong, 8)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        new_tail, ref = fft2.fft2_transform(geo, tables, parts.tail, weak,
                                            strong)
        parts, ref_power = fft2.fft2_power_update(geo, parts, new_tail,
                                                  ref, 8)
        got = (spec, power, whole.tail, whole.sumsq_avg)
        want = (ref, ref_power, parts.tail, parts.sumsq_avg)
        if spec.shape != (geo.fft2_frames_per_step, geo.fft2_size,
                          geo.channels) \
                or not all(torch.isfinite(x).all().item() for x in got):
            raise AssertionError(f"fft2_step: step {step} spectra "
                                 f"{tuple(spec.shape)} or non-finite")
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"fft2_step: step {step} differs from "
                                 f"fft2_transform + fft2_power_update")
    if fused_fft1.launches:
        raise AssertionError(f"fft2_step: fused_fft1 launched "
                             f"{fused_fft1.launches} times")
    print(f"fft2_step: {steps} steps at fft2 {geo.fft2_size} x "
          f"{geo.fft2_frames_per_step} frames, bit-equal to fft2_transform "
          f"then fft2_power_update (the last with allow_tf32 = True set "
          f"by the caller); make_tail zeros of the state's tail shape; "
          f"fused_fft1 launches 0; phase "
          f"{time.perf_counter() - t0:.1f} s [{dev['smi']}]")


def graph_report_one(graph, label: str, dev: dict) -> None:
    print(f"graphed {label}: {graph.replays} replays, {graph.kernels} "
          f"fused_fft1 node(s), capture {capture_s(graph):.3f} s, graph "
          f"pool {graph_pool_bytes(graph.graph)} bytes [{dev['smi']}]")


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
    per stage and step, averaged over ``steps`` steps after 2 of warm-up,
    and beside it the stage's device kernels and copies in one more step,
    each stage under a torch.profiler of its own.  The synced step is
    slower than the free-running one."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline import chain
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    p = multi_params("pallas", False)
    geo = derive_geometry(p)
    dials = multi_dials(geo, k_sub)
    iq = make_input(geo, seed=5, steps=steps + 2, tones=dials,
                    tone_amplitude=MULTI_TONE_AMPLITUDE,
                    spur=(MULTI_SPUR_HZ, MULTI_SPUR_AMPLITUDE))
    # the eager step: its stage functions are wrapped below
    rx = MultiReceiver(p, k_sub, graphed=False)
    for k, f in enumerate(dials):
        rx.tune_subch(k, f)
    # a slot on each carrier, as the manager sets them in phase 8
    n, fs = geo.fftx_size, geo.timf1_sampling_speed
    rx.state.spur.bins[0] = int(round(CARRIER_HZ / fs * n)) % n
    rx.state.spur.bins[1] = int(round(MULTI_SPUR_HZ / fs * n)) % n
    s = geo.samples_per_step
    blocks = [torch.from_numpy(iq[i * s:(i + 1) * s]).cuda()
              for i in range(steps + 2)]
    from torch.profiler import ProfilerActivity, profile
    spent, kernels, counting = {}, {}, []

    def timed(fn, name):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            if counting:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                kernels[name] = kernels.get(name, 0) + sum(
                    e.count for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
                return out
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
        counting.append(True)
        rx.process_block(blocks[-1])
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    print(f"stage split, MultiReceiver K={k_sub}, synced wall ms per stage "
          f"over {steps} steps, and device kernels and copies per stage "
          f"in one more [{dev['smi']}]:")
    for name, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {1e3 * sec / steps:.3f} ms, "
              f"{kernels.get(name, 0)} kernels")
    rest = whole - sum(spent.values())
    print(f"  outside the stages: {1e3 * rest / steps:.3f}; whole synced "
          f"step {1e3 * whole / steps:.3f}")


BAND_CONFIG = "rxbench/configs/ssb-multi24-2msps.json"
BAND_TRAFFIC = "rxbench/traffic/band.json"
BAND_STEPS = 6
BAND_TIMED = 10
# each hand kernel's launches in one band step: the fused fft1 takes at most
# 4,096 points, so at 32,768 fft1 runs on cuFFT
BAND_KERNELS = {"blanker_fits": 1, "blanker_clear": 1, "sellim_taper": 1,
                "sellim_update": 2}
BAND_TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
                 max_pulses_per_block=8)


def band_params(tiny: bool = False) -> tuple:
    """The band station's RxParams (its configuration file's ``params``;
    tiny: fft1 256, 2,048 samples a step) and its sub-receivers."""
    from linrad_tpu_torch.params import RxParams
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, BAND_CONFIG)) as f:
        cfg = json.load(f)
    fields = {**cfg["params"], **(BAND_TINY if tiny else {})}
    return (RxParams.from_json(json.dumps(fields), strict=True),
            cfg["sub_receivers"])


def band_input(geo, steps: int, device, seed: int = 25) -> tuple:
    """``steps`` blocks of the cell's traffic (host complex64) and the
    stations' frequencies, where the sub-receivers are tuned."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from rxbench.generators import band
    with open(os.path.join(root, BAND_TRAFFIC)) as f:
        spec = {**json.load(f)["ring"], "steps": steps}

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    return (band.make_ring(geo, spec, gen(), 0.0),
            band.sub_receiver_hz(geo, spec, gen()))


def phase_band(dev: dict, device="cuda", tiny: bool = False) -> None:
    """Phase 25: the band station's widths.  ``device="cpu"`` with
    ``tiny=True`` rehearses the control flow (no kernel cases there, and
    graphed=True runs the graph's body eagerly)."""
    from linrad_tpu_torch import derive_geometry
    from linrad_tpu_torch.pipeline.receiver import MultiReceiver
    from linrad_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    p, k = band_params(tiny)
    geo = derive_geometry(p)
    iq, hz = band_input(geo, BAND_STEPS + BAND_TIMED, device)
    s = geo.samples_per_step
    blocks = [iq[i * s:(i + 1) * s] for i in range(iq.shape[0] // s)]
    print(f"band: fft1 {geo.fft1_size}, fft2 {geo.fft2_size}, mix1 "
          f"{geo.mix1_size}, {s} samples a step, {k} sub-receivers from "
          f"{hz[0]:.1f} to {hz[k - 1]:.1f} Hz [{dev['smi']}]", flush=True)

    # (a) the kernels at the band's widths against their plain versions
    if on_card:
        from linrad_tpu_torch.ops import fused_fft1 as ff
        from linrad_tpu_torch.utils.timing import graph_ms
        cuda = torch.device("cuda", torch.cuda.current_device())
        floor = graph_ms(lambda: ff.empty_launch(cuda), 50, 20)
        fits, _tapers, clears, updates = loop_args(p, iq, float(hz[0]), 2)
        update_case(dev, "band edge n32768", update_edge_args("n32768"),
                    floor, plain_device=False)
        for i, args in enumerate(updates):
            update_case(dev, f"band step {i}", args, floor)
        fits_case(dev, "band", fits[-1], floor)
        clear_case(dev, "band", clears[-1], floor)
    else:
        print("band: the kernel cases need the card", flush=True)

    # (b) MultiReceiver with K sub-receivers, graphed against eager: each
    # kernel's calls counted from 0, so that one step's are known exactly
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for count in cuda_build.COUNTS.values():
        count.launches = count.captured = 0

    def captured() -> int:
        return sum(c.captured for c in cuda_build.COUNTS.values())

    def calls(field: str) -> dict:
        return {name: getattr(c, field) for name, c in
                cuda_build.COUNTS.items() if getattr(c, field)}

    def receiver(graphed):
        rx = MultiReceiver(p, k, device=device, graphed=graphed,
                           recorded=captured)
        for j in range(k):
            rx.tune_subch(j, float(hz[j]))
        return rx

    graphed = receiver(None if on_card else True)
    eager = receiver(False)
    for i, b in enumerate(blocks[:BAND_STEPS]):
        equal_outputs(graphed.process_block(b), eager.process_block(b),
                      f"band step {i}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"band: MultiReceiver K = {k}, {BAND_STEPS} steps, every "
          f"RxOutputs field of the graph bit-equal to graphed=False's; "
          f"{graphed.kernels_per_replay} hand kernels a replay; peak device "
          f"memory {peak} bytes [{dev['smi']}]", flush=True)
    if on_card:
        g = graphed._lead
        print(f"band graph: {g.replays} replays, {g.kernels} hand kernel "
              f"calls recorded, capture {capture_s(g):.3f} s, graph pool "
              f"{graph_pool_bytes(g.graph)} bytes [{dev['smi']}]", flush=True)
        if (calls("captured") != BAND_KERNELS
                or graphed.kernels_per_replay != sum(BAND_KERNELS.values())):
            raise AssertionError(f"band: the graph recorded "
                                 f"{calls('captured')}, expected "
                                 f"{BAND_KERNELS}")
        for count in cuda_build.COUNTS.values():
            count.launches = 0

    def ms_a_block(rx) -> float:
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        for b in blocks[BAND_STEPS:]:
            rx.process_block(b).audio.cpu()
        return 1e3 * (time.perf_counter() - t) / (len(blocks) - BAND_STEPS)

    turns = [("graph", graphed), ("eager", eager), ("eager", eager),
             ("graph", graphed)]
    print("band timing: ms a block (copy in, step, every audio to the "
          "host) " + ", ".join(f"{name} {ms_a_block(rx):.3f}"
                               for name, rx in turns)
          + f" [{dev['smi']}]", flush=True)
    # the graph's replays launch nothing through the wrappers; each of the
    # eager receiver's steps launches each kernel as often as a replay does
    eager_steps = 2 * (len(blocks) - BAND_STEPS)
    want = {name: eager_steps * n for name, n in BAND_KERNELS.items()}
    if on_card:
        if calls("launches") != want:
            raise AssertionError(f"band: {eager_steps} eager steps launched "
                                 f"{calls('launches')}, expected {want}")
        print(f"band: launches a step {BAND_KERNELS}, the fused fft1 none; "
              f"graph replays none through the wrappers", flush=True)
    print(f"band: phase in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    t0 = time.perf_counter()
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
    loops = phase_loop_kernels(dev)
    launches, loop_launches = phase_main()
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
    launches += phase_weak(dev)
    launches += phase_sharded(dev)
    launches += phase_graphed(dev)
    launches += phase_presets(dev)
    radar_launches, loop_launches["radar_stats"] = phase_radar_mode(dev)
    launches += radar_launches
    phase_fft2_step(dev)
    phase_band(dev)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} "
          f"s [{dev['smi']}]")
    entries = [{
        "name": "fused_fft1", "route": "cuda",
        "source": "linrad_tpu_torch/csrc/fused_fft1.cu",
        "replaces": "linrad_tpu/ops/pallas_fft.py:59",
        "launches": launches, **kern[MAIN_SHAPE],
        "by_shape": {"x".join(map(str, shape)): v
                     for shape, v in kern.items()}}]
    for name, replaces in LOOP_KERNELS:
        entries.append({
            "name": name, "route": "cuda",
            "source": f"linrad_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": loop_launches[name],
            **loops[name][LOOP_MAIN_CASE.get(name, "flagship")],
            "by_case": {str(k): v for k, v in loops[name].items()}})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
