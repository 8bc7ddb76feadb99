"""Fused first FFT: window -> FFT -> calibration multiply -> power sum.

The port of ``linrad_tpu/ops/pallas_fft.py`` (the TPU's one Pallas
kernel).  On a CUDA tensor :func:`fused_fft1` launches the hand-written
Hopper kernel in ``csrc/fused_fft1.cu``, once; on a CPU tensor it runs
:func:`fused_fft1_reference`, the plain PyTorch version of the same
function.  There is no fallback between the two: a CUDA tensor either
goes through the kernel or raises.  It is a PyTorch custom operator, so
that ``torch.func.vmap`` over a fleet of receivers batches it into one
launch (:func:`_fused_fft1_vmap`).

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/linrad_tpu_torch/`` under the repository root and loaded with
``ctypes`` (a plain C entry point; no PyTorch headers).

What the kernel leaves to Python is here, as pure functions the CPU tests
reach: :func:`radix_plan` (the factorisation of N into radix-8 and
radix-4 passes), :func:`launch_plan` (channels per block, threads, frames
per block, grid, shared memory) and :func:`necessary_bytes` (the bytes
the function must move, behind the kernel's bound).
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

CLUSTER = 8                 # blocks per cluster (the kernel's kCluster)
MAX_THREADS = 1024
MAX_SMEM_BYTES = 232_448    # 227 KB, the most shared memory a block may use
SMEM_PER_SM = 233_472       # 228 KB on an SM, 1 KB of it reserved per block
H100_SMS = 132
# Blocks per multiprocessor the plan counts on.  Four overlap one block's
# loads and stores with the others' passes; measured on an H100, more of
# them (small transforms would allow up to 32) only added partial rows to
# sum and were slower.
MAX_BLOCKS_PER_SM = 4

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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lrt_empty_launch.argtypes = [ctypes.c_void_p]
    lib.lrt_empty_launch.restype = ctypes.c_int
    return lib, info


def radix_plan(n: int) -> tuple[int, ...]:
    """The radices of the kernel's Stockham passes over a transform of
    size n, in order: radix 8 as often as log2 n allows, radix 4 for the
    rest (128 = 8*4*4, 2048 = 8*8*8*4, 4096 = 8*8*8*8)."""
    if n < MIN_SIZE or n > MAX_SIZE or n & (n - 1):
        raise ValueError(f"fused_fft1: unsupported transform size {n}")
    eights, rem = divmod(n.bit_length() - 1, 3)
    if rem == 0:
        return (8,) * eights
    if rem == 2:
        return (8,) * eights + (4,)
    return (8,) * (eights - 1) + (4, 4)


def twiddle_tables(n: int) -> np.ndarray:
    """The kernel's twiddle factors: for every pass but the first, of
    radix r after passes of product p, exp(-2 pi i j k / (p r)) at
    [k (r - 1) + j - 1] for k < p, j = 1..r-1; the passes' tables one
    after the other, padded with zeros to n entries.  Built in float64,
    stored complex64."""
    tables, p = [], 1
    for i, r in enumerate(radix_plan(n)):
        if i > 0:
            k = np.arange(p)[:, None]
            j = np.arange(1, r)[None, :]
            tables.append(np.exp(-2j * np.pi * j * k / (p * r)).ravel())
        p *= r
    out = np.zeros(n, np.complex64)
    flat = np.concatenate(tables)
    out[:flat.size] = flat
    return out


def launch_plan(b: int, n: int, c: int, sms: int = H100_SMS) -> dict:
    """How the kernel is launched at shape (b, n, c) on a card of ``sms``
    multiprocessors.

    A block takes ``ch`` channels (both of two; pairs of an even count;
    single channels of an odd count, along grid y) of
    ``frames_per_block`` frames, one after the other, with one thread per
    radix-8 butterfly.  Its shared memory holds two exchange buffers,
    padded by one point in 16, and the running power row with its
    compensation: 25 bytes per point.
    ``frames_per_block`` is the least count with which the whole grid is
    resident at once (as many blocks per multiprocessor as shared memory
    and threads allow, at most MAX_BLOCKS_PER_SM), so the card is filled
    before a block is given a second frame; the grid along x is rounded up to whole clusters of 8
    (blocks past the last frame add zeros).  Each cluster leaves one row
    of partial power sums: ``clusters`` rows of scratch instead of b."""
    radix_plan(n)
    if b < 1 or c < 1:
        raise ValueError("fused_fft1: empty batch or channel axis")
    ch = 2 if c % 2 == 0 else 1
    chunks = c // ch
    threads = max(32, n * ch // 8)
    smem = 25 * n * ch
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads,
                        MAX_BLOCKS_PER_SM))
    resident_x = max(CLUSTER, sms * per_sm // chunks // CLUSTER * CLUSTER)
    frames_per_block = -(-b // resident_x)
    blocks = -(-b // frames_per_block)
    grid_x = -(-blocks // CLUSTER) * CLUSTER
    return {"ch": ch, "threads": threads, "smem_bytes": smem,
            "frames_per_block": frames_per_block,
            "grid": (grid_x, chunks), "clusters": grid_x // CLUSTER,
            "blocks_per_sm": per_sm, "radices": radix_plan(n)}


def necessary_bytes(b: int, n: int, c: int) -> int:
    """Bytes the function must move: every input read once (frames,
    window, filtercorr) and every output written once (spec, power_sum)."""
    return 8 * b * n * c + 4 * n + 8 * n * c + 8 * b * n * c + 4 * n * c


def operations(b: int, n: int, c: int) -> int:
    """Float32 operations of the function: 5 n log2 n per transform, and
    per point 2 for the window, 6 for the calibration, 4 for the power."""
    return b * c * (5 * n * (n.bit_length() - 1) + 12 * n)


class _Launch:
    """What one (device, stream, shape) needs for every launch, built
    once: the twiddle table, the scratch rows with the ticket counters,
    and the constant ctypes arguments (the plan among them)."""

    def __init__(self, device: torch.device, b: int, n: int, c: int):
        lib, _ = build()
        self.fn = lib.lrt_fused_fft1
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(b, n, c, sms)
        self.twiddle = torch.from_numpy(twiddle_tables(n)).to(device)
        # one allocation: the ticket counters, 8 for each grid row (zero
        # now, and the kernel leaves them zero), then one row of n c floats
        # per cluster
        pad = CLUSTER * plan["grid"][1]
        self.scratch = torch.zeros(pad + plan["clusters"] * n * c,
                                   dtype=torch.float32, device=device)
        self.tail = (
            ctypes.c_void_p(self.scratch.data_ptr() + 4 * pad),
            ctypes.c_void_p(self.scratch.data_ptr()),
            b, n, c, plan["ch"], plan["threads"], plan["frames_per_block"],
            plan["grid"][0], plan["smem_bytes"])
        self.twiddle_ptr = ctypes.c_void_p(self.twiddle.data_ptr())


@functools.lru_cache(maxsize=64)
def _launch(device: torch.device, stream: int, b: int, n: int, c: int
            ) -> _Launch:
    """Cached per stream as well: the scratch rows and tickets of one
    launch must not be shared with a launch running beside it."""
    return _Launch(device, b, n, c)


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
    B of |spec|^2).  N must be a power of two in [128, 4096].

    A PyTorch custom operator (``torch.ops.linrad_tpu_torch.fused_fft1``)
    with a rule for ``torch.func.vmap``: under vmap over R streams, frames
    (R, B, N, C) are folded into the channel axis, (B, N, R C), and one
    launch serves every stream (see :func:`_fused_fft1_vmap`)."""
    _check(frames, window, filtercorr)
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_fft1: unsupported device {frames.device}")
    return torch.ops.linrad_tpu_torch.fused_fft1(frames, window, filtercorr)


@torch.library.custom_op("linrad_tpu_torch::fused_fft1", mutates_args=())
def _fused_fft1_op(frames: torch.Tensor, window: torch.Tensor,
                   filtercorr: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    b, n, c = _check(frames, window, filtercorr)
    if frames.device.type == "cpu":
        return fused_fft1_reference(frames, window, filtercorr)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_fft1: unsupported device {frames.device}")
    if not (frames.is_contiguous() and window.is_contiguous()
            and filtercorr.is_contiguous()):
        raise ValueError("fused_fft1: inputs must be contiguous")
    dev = frames.device
    if (frames.data_ptr() | filtercorr.data_ptr() | window.data_ptr()) % 16:
        raise ValueError("fused_fft1: inputs must be 16-byte aligned")
    # the current stream's handle without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    st = _launch(dev, stream, b, n, c)
    spec = torch.empty_like(frames)
    psum = torch.empty((n, c), dtype=torch.float32, device=dev)
    args = (frames.data_ptr(), window.data_ptr(), filtercorr.data_ptr(),
            st.twiddle_ptr, spec.data_ptr(), psum.data_ptr(), *st.tail,
            stream)
    if dev.index == torch.cuda.current_device():
        err = st.fn(*args)
    else:
        with torch.cuda.device(dev):
            err = st.fn(*args)
    if err != 0:
        raise RuntimeError(f"fused_fft1: kernel launch failed with CUDA "
                           f"error {err} at shape {(b, n, c)}")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph, nothing launched: whoever replays the
        # graph counts its launches
        fused_fft1.captured += 1
    else:
        fused_fft1.launches += 1
    return spec, psum


@_fused_fft1_op.register_fake
def _fused_fft1_fake(frames, window, filtercorr):
    _b, n, c = frames.shape
    return (torch.empty_like(frames),
            frames.new_empty((n, c), dtype=torch.float32))


@_fused_fft1_op.register_vmap
def _fused_fft1_vmap(info, in_dims, frames, window, filtercorr):
    """R streams in one launch: the stream axis is folded into the
    channel axis.  frames (R, B, N, C) -> (B, N, R, C), contiguous, read
    as (B, N, R C) (one copy of the frames); filtercorr (N, C) expanded,
    or (R, N, C) permuted, to (N, R C); the window is shared.  The
    results come back as views: spec (R, B, N, C), power_sum (R, N, C)."""
    f_dim, w_dim, c_dim = in_dims
    if w_dim is not None:
        raise NotImplementedError("fused_fft1 under vmap: the window must "
                                  "be shared by every stream")
    r = info.batch_size
    frames = (frames.movedim(f_dim, 0) if f_dim is not None
              else frames.expand((r,) + tuple(frames.shape)))
    _r, b, n, c = frames.shape
    folded = frames.permute(1, 2, 0, 3).contiguous().reshape(b, n, r * c)
    if c_dim is None:
        fc = filtercorr[:, None, :].expand(n, r, c)
    else:
        fc = filtercorr.movedim(c_dim, 0).permute(1, 0, 2)
    fc = fc.contiguous().reshape(n, r * c)
    spec, psum = fused_fft1(folded, window, fc)
    return ((spec.reshape(b, n, r, c).permute(2, 0, 1, 3),
             psum.reshape(n, r, c).permute(1, 0, 2)), (0, 0))


def empty_launch(device: torch.device) -> None:
    """Launch the library's empty kernel on the device's current stream:
    the yardstick for what any kernel launch costs."""
    lib, _ = build()
    with torch.cuda.device(device):
        err = lib.lrt_empty_launch(
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_fft1: empty launch failed with CUDA "
                           f"error {err}")


fused_fft1.launches = 0
fused_fft1.captured = 0
