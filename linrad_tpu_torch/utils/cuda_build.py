"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each source ``linrad_tpu_torch/csrc/<name>.cu`` has a plain C interface
(no PyTorch headers) and is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own, ``build/linrad_tpu_torch/lib<name>_<digest>.so``
under the repository root, at first use.  The digest covers the source's
contents and the flags, so an edited source is built anew and an unchanged
one is loaded as it is.  :func:`build_all` starts one ``nvcc`` per source,
all at once.  A :class:`LaunchCount` counts a kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "linrad_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("fused_fft1", "blanker_fits", "sellim_taper", "blanker_clear",
           "radar_stats")


def nvcc(name: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name}: nvcc not found (PATH, CUDA_HOME or "
                       f"/usr/local/cuda/bin); the CUDA kernel cannot be "
                       f"built")


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``csrc/<name>.cu`` (once per version of its contents) and
    load it.

    Returns (library, info) where info holds the library path, the build
    seconds (0.0 when an earlier build of the same source was reused) and
    the compiler's output (``-Xptxas -v``: registers, shared memory)."""
    src_path = CSRC / f"{name}.cu"
    src = src_path.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:12]}.so"
    info = {"path": str(lib_path), "build_seconds": 0.0, "log": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(name), *NVCC_FLAGS, "-o", str(tmp),
                               str(src_path)], capture_output=True,
                              text=True)
        info["build_seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n"
                               f"{info['log']}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), info


def build_all(names=KERNELS) -> dict:
    """Build every named source at once, one ``nvcc`` each; name ->
    (library, info).  A failure raises once every build has ended."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def launch(fn, args: tuple, device: torch.device, what: str) -> None:
    """Call the C launcher ``fn`` with ``device`` current; it returns the
    CUDA error of the launch (``cudaGetLastError``), and anything but 0
    raises."""
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


class LaunchCount:
    """A kernel's calls: ``launches`` made outside a CUDA graph's capture,
    ``captured`` recorded into one (nothing runs then: whoever replays the
    graph counts its launches).  Its wrapper adds one where it launches
    the kernel, and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0
        self.captured = 0

    def add(self) -> None:
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
