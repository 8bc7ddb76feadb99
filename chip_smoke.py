"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA, print the card, its power limit, the torch and
            CUDA versions; turn TF32 off for matmul and cuDNN.
2. build    build the fused fft1 kernel from linrad_tpu_torch/csrc/ with
            nvcc (sm_90a) and print the build seconds.
3. kernel   fused_fft1 (kernel) against fused_fft1_reference (plain
            PyTorch) on the card at four shapes, the flagship's among
            them; max_rel <= 1e-5 for spectrum and power sum; CUDA-event
            times for both.
4. main     the flagship receive step (96 kHz IQ, 65,536 samples per
            step, fft1 2048 with the kernel) through Receiver for 8 steps
            of a weak keyed CW tone, Gaussian noise, impulse noise and a
            strong carrier; the kernel's launch count must rise by one per
            step; the same input through a Receiver on torch.fft
            ("xla") must agree within the stated bars.
5. timing   step time and complex Msamples/s for both receivers.

It prints a JSON line describing every kernel of the path, then, as the
last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 8
KERNEL_SHAPES = [(3, 128, 1), (40, 512, 2), (64, 2048, 1), (2048, 2048, 1)]
MAIN_SHAPE = (64, 2048, 1)
KERNEL_TOL = 1e-5
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


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a-b| / max(max|a|, max|b|), in double precision."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    a = a.detach().to(wide)
    b = b.detach().to(wide)
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return (a - b).abs().max().item() / scale


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        if "registers" in line or "smem" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernel(dev: dict) -> dict:
    from linrad_tpu_torch.ops.fused_fft1 import (fused_fft1,
                                                 fused_fft1_reference)
    before = fused_fft1.launches
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
        spec_k, pow_k = fused_fft1(frames, window, fc)
        spec_r, pow_r = fused_fft1_reference(frames, window, fc)
        torch.cuda.synchronize()
        rel_s = max_rel(spec_k, spec_r)
        rel_p = max_rel(pow_k, pow_r)
        abs_err = max((spec_k - spec_r).abs().max().item(),
                      (pow_k - pow_r).abs().max().item())
        reps = 50 if b * n <= 1 << 17 else 10
        for _ in range(3):
            fused_fft1(frames, window, fc)
            fused_fft1_reference(frames, window, fc)
        plain = cuda_ms(lambda: fused_fft1_reference(frames, window, fc), reps)
        kern = cuda_ms(lambda: fused_fft1(frames, window, fc), reps)
        kern = 0.5 * (kern + cuda_ms(lambda: fused_fft1(frames, window, fc),
                                     reps))
        plain = 0.5 * (plain + cuda_ms(
            lambda: fused_fft1_reference(frames, window, fc), reps))
        print(f"kernel fused_fft1 {(b, n, c)}: spec max_rel {rel_s:.3e}, "
              f"power_sum max_rel {rel_p:.3e}, max_abs_err {abs_err:.3e}; "
              f"kernel {kern:.4f} ms, plain {plain:.4f} ms [{dev['smi']}]")
        if not (rel_s <= KERNEL_TOL and rel_p <= KERNEL_TOL):
            raise AssertionError(f"fused_fft1 {(b, n, c)} disagrees with "
                                 f"its plain version: {rel_s}, {rel_p}")
        report[(b, n, c)] = {"max_abs_err": abs_err, "ms": kern,
                             "plain_ms": plain}
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
    for i, out in enumerate(outs):
        for k, shape in shapes.items():
            v = getattr(out, k)
            if tuple(v.shape) != shape:
                raise AssertionError(f"step {i} {k}: shape "
                                     f"{tuple(v.shape)} != {shape}")
            if not torch.isfinite(v).all().item():
                raise AssertionError(f"step {i} {k}: non-finite values")
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

    ref = run_receiver("xla", iq)
    # worst max_rel per field: over the start-up step, and over the rest
    start, steady = {}, {}
    for i, (a, b) in enumerate(zip(outs, ref)):
        for k in shapes:
            va, vb = getattr(a, k), getattr(b, k)
            if k in ("blanker_fitted", "blanker_cleared"):
                if int(va) != int(vb):
                    raise AssertionError(f"step {i} {k}: {int(va)} != "
                                         f"{int(vb)}")
                continue
            if k == "liminfo" and not torch.equal(torch.sign(va),
                                                  torch.sign(vb)):
                raise AssertionError(f"step {i}: liminfo sign pattern "
                                     f"differs")
            worst = start if i == 0 else steady
            worst[k] = max(worst.get(k, 0.0), max_rel(va, vb))
    failed = []
    for label, worst in (("step 0", start), (f"steps 1-{STEPS - 1}", steady)):
        for k, v in worst.items():
            bar = CHAIN_TOL.get(k, CHAIN_TOL_OTHER)
            if label == "step 0" and k == "audio":
                bar = START_AUDIO_TOL
            print(f"pallas vs xla on the card, {label}: {k} max_rel "
                  f"{v:.3e} (bar {bar})")
            if v > bar:
                failed.append(f"{label} {k}: max_rel {v} > {bar}")
    if failed:
        raise AssertionError("; ".join(failed))
    print("pallas vs xla: liminfo sign pattern and blanker counts exact in "
          "every step")
    return launches


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


def main() -> None:
    dev = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    launches = phase_main()
    phase_timing(dev)
    k = kern[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "fused_fft1", "route": "cuda",
        "source": "linrad_tpu_torch/csrc/fused_fft1.cu",
        "replaces": "linrad_tpu/ops/pallas_fft.py:59",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
