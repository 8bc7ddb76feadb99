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

It prints a JSON line describing every kernel of the paths (launches
summed over the flagship and EME runs; times at the flagship's shape, and
per shape under "by_shape"), then, as the last line,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 8
KERNEL_SHAPES = [(3, 128, 1), (40, 512, 2), (64, 2048, 1), (2048, 2048, 1),
                 (64, 4096, 2),
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
TUNE_HZ = 12_345.6
CARRIER_HZ = -21_000.0
# the EME path
EME_STEPS = 12
EME_TIME_STEPS = 8
EME_TUNE_HZ = 1_000.0
EME_POL = np.array([0.8, 0.6j])
EME_BFO_HZ = 600.0


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


def make_input(geo, seed: int = 0) -> np.ndarray:
    """STEPS steps of: weak on/off-keyed CW at the dial frequency TUNE_HZ
    (the BFO puts it at 800 Hz audio), complex Gaussian noise, impulse
    noise and a strong carrier."""
    rng = np.random.default_rng(seed)
    fs = geo.timf1_sampling_speed
    n = STEPS * geo.samples_per_step
    t = np.arange(n) / fs
    key = (np.floor(t / 0.06) % 4 < 2).astype(np.float64)   # 60 ms elements
    tone = 10.0 * key * np.exp(2j * np.pi * TUNE_HZ * t)
    carrier = 2000.0 * np.exp(2j * np.pi * CARRIER_HZ * t + 0.3j)
    noise = 10.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    imp = np.zeros(n, np.complex128)
    pos = rng.integers(0, n, size=STEPS * max(8, geo.samples_per_step // 1600))
    imp[pos] = 3000.0 * np.exp(2j * np.pi * rng.uniform(size=pos.size))
    return (tone + carrier + noise + imp).astype(np.complex64)[:, None]


def run_receiver(variant: str, iq: np.ndarray) -> list:
    """Receiver on the card, tuned to the tone, over every step of iq."""
    from linrad_tpu_torch import flagship_params
    from linrad_tpu_torch.pipeline.receiver import Receiver
    rx = Receiver(flagship_params(fft1_variant=variant), device="cuda")
    rx.tune(TUNE_HZ)
    outs = list(rx.run(iq))
    torch.cuda.synchronize()
    return outs


def phase_main() -> int:
    """Returns the kernel's launch count over the main path's steps."""
    from linrad_tpu_torch import derive_geometry, flagship_params
    from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
    geo = derive_geometry(flagship_params())
    iq = make_input(geo)
    fused_fft1.launches = 0
    outs = run_receiver("pallas", iq)
    launches = fused_fft1.launches
    print(f"main path: {len(outs)} steps of {geo.samples_per_step} samples, "
          f"fused_fft1 launches {launches}")
    if launches != STEPS or len(outs) != STEPS:
        raise AssertionError(f"expected {STEPS} kernel launches (one per "
                             f"step), saw {launches}")
    shapes = {"audio": (geo.baseband_samples_per_step, 1),
              "baseb": (geo.baseband_samples_per_step, 1),
              "fft1_power": (geo.fft1_size, 1),
              "fft1_avg_power": (geo.fft1_size, 1),
              "agc_gain": (geo.baseband_samples_per_step, 1),
              "fft2_power": (geo.fft2_size, 1),
              "liminfo": (geo.fft1_size,),
              "blanker_fitted": (), "blanker_cleared": (),
              "noise_floor": ()}
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

    compare_runs(outs, run_receiver("xla", iq), shapes, "")
    return launches


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


def compare_runs(outs: list, ref: list, keys, label: str) -> None:
    """The receiver through the kernel (outs) against the receiver through
    torch.fft (ref): blanker counts and the liminfo sign pattern exact in
    every step, each float field within its bar (step 0's audio within
    START_AUDIO_TOL)."""
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
            if span == "step 0" and k == "audio":
                bar = START_AUDIO_TOL
            print(f"{label}pallas vs xla on the card, {span}: {k} max_rel "
                  f"{v:.3e} (bar {bar})")
            if v > bar:
                failed.append(f"{label}{span} {k}: max_rel {v} > {bar}")
    if failed:
        raise AssertionError("; ".join(failed))
    print(f"{label}pallas vs xla: liminfo sign pattern and blanker counts "
          f"exact in every step")


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


def main() -> None:
    dev = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    launches = phase_main()
    phase_timing(dev)
    eme_launches, eme_rx, eme_iq = phase_eme()
    phase_eme_timing(dev, eme_rx, eme_iq)
    launches += eme_launches
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
