"""Fused first FFT: window -> FFT -> calibration multiply -> power sum.

The port of ``linrad_tpu/ops/pallas_fft.py`` (the TPU's one Pallas
kernel).  On a CUDA tensor :func:`fused_fft1` launches the hand-written
Hopper kernel in ``csrc/fused_fft1.cu``; on a CPU tensor it runs
:func:`fused_fft1_reference`, the plain PyTorch version of the same
function.  There is no fallback between the two: a CUDA tensor either
goes through the kernel or raises.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/linrad_tpu_torch/`` under the repository root and loaded with
``ctypes`` (a plain C entry point; no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

MIN_SIZE = 128
MAX_SIZE = 4096

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_fft1.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "linrad_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("fused_fft1: nvcc not found (PATH, CUDA_HOME or "
                       "/usr/local/cuda/bin); the CUDA kernel cannot be "
                       "built")


@functools.lru_cache(maxsize=1)
def build() -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source version) and load the kernel library.

    Returns (library, info) where info holds the library path, the build
    seconds (0.0 when an earlier build of the same source was reused) and
    the compiler's output (``-Xptxas -v``: registers, shared memory)."""
    src = _SRC.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"libfused_fft1_{digest[:12]}.so"
    info = {"path": str(lib_path), "build_seconds": 0.0, "log": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        info["build_seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"fused_fft1: nvcc failed "
                               f"({proc.returncode}):\n{info['log']}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.lrt_fused_fft1
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, info


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i m / n) for m < n/2, built in float64, stored complex64."""
    tw = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _check(frames: torch.Tensor, window: torch.Tensor,
           filtercorr: torch.Tensor) -> tuple[int, int, int]:
    if frames.dim() != 3:
        raise ValueError(f"fused_fft1: frames must be (B, N, C), got "
                         f"{tuple(frames.shape)}")
    b, n, c = frames.shape
    if n < MIN_SIZE or n > MAX_SIZE or n & (n - 1):
        raise ValueError(f"fused_fft1: unsupported transform size {n}")
    if frames.dtype != torch.complex64 or filtercorr.dtype != torch.complex64:
        raise ValueError("fused_fft1: frames and filtercorr must be "
                         "complex64")
    if window.dtype != torch.float32:
        raise ValueError("fused_fft1: window must be float32")
    if tuple(window.shape) != (n,) or tuple(filtercorr.shape) != (n, c):
        raise ValueError(f"fused_fft1: window {tuple(window.shape)} / "
                         f"filtercorr {tuple(filtercorr.shape)} do not match "
                         f"frames {tuple(frames.shape)}")
    if not (window.device == frames.device == filtercorr.device):
        raise ValueError("fused_fft1: tensors on different devices")
    if b == 0 or c == 0:
        raise ValueError("fused_fft1: empty batch or channel axis")
    return b, n, c


def fused_fft1_reference(frames: torch.Tensor, window: torch.Tensor,
                         filtercorr: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: window, FFT, calibration, power sum."""
    spec = torch.fft.fft(frames * window[None, :, None], dim=1)
    spec = spec * filtercorr[None, :, :]
    return spec, (spec.abs() ** 2).sum(0)


def fused_fft1(frames: torch.Tensor, window: torch.Tensor,
               filtercorr: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused window + FFT + calibration + power accumulation.

    frames:     (B, N, C) complex64 overlapped input frames, contiguous
    window:     (N,) float32 sin^N analysis window
    filtercorr: (N, C) complex64 calibration spectrum

    Returns (spec (B, N, C) complex64, power_sum (N, C) float32 = sum over
    B of |spec|^2).  N must be a power of two in [128, 4096]."""
    b, n, c = _check(frames, window, filtercorr)
    if frames.device.type == "cpu":
        return fused_fft1_reference(frames, window, filtercorr)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_fft1: unsupported device {frames.device}")
    if not (frames.is_contiguous() and window.is_contiguous()
            and filtercorr.is_contiguous()):
        raise ValueError("fused_fft1: inputs must be contiguous")
    lib, _ = build()
    dev = frames.device
    tw = _twiddles(n, dev)
    spec = torch.empty((b, n, c), dtype=torch.complex64, device=dev)
    rows = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    psum = torch.empty((n, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lrt_fused_fft1(frames.data_ptr(), window.data_ptr(),
                                 filtercorr.data_ptr(), tw.data_ptr(),
                                 spec.data_ptr(), rows.data_ptr(),
                                 psum.data_ptr(), b, n, c, stream)
    if err != 0:
        raise RuntimeError(f"fused_fft1: kernel launch failed with CUDA "
                           f"error {err} at shape {(b, n, c)}")
    fused_fft1.launches += 1
    return spec, psum


fused_fft1.launches = 0
