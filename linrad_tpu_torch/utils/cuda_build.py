"""The port's hand-written CUDA kernels: what a hand kernel is, in one place.

Each source ``linrad_tpu_torch/csrc/<name>.cu`` has a plain C interface
(no PyTorch headers) and is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own, ``build/linrad_tpu_torch/lib<name>_<digest>.so``
under the repository root, at first use.  The digest covers the source's
contents and the flags, so an edited source is built anew and an unchanged
one is loaded as it is.  :data:`KERNELS` are the sources found in
``csrc/``; :func:`build_all` starts one ``nvcc`` per source, all at once.

Around a kernel, its operator's module keeps what is its own (the plain
version, the argument check, the C argument list, the custom operator, its
fake, the card half of its vmap rule); this module does the rest:
:func:`bind` types a C function of the library, :func:`launch` calls it on
the device's current stream and counts the launch in the kernel's
:func:`launch_count` (which the tracer's report reads from :data:`COUNTS`),
:func:`on_device` runs the plain version on a CPU tensor and the kernel's
path on a CUDA tensor, and :class:`Streams` gives an operator whose card
path takes a stream axis its one-stream call and its vmap rule.  Nothing
is built or bound before a kernel's first launch.
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
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
COUNTS: dict = {}       # kernel -> its launch count, as its module made it


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


@functools.lru_cache(maxsize=None)
def bind(kernel: str, symbol: str, argtypes: tuple, expect: tuple = ()):
    """The C function ``symbol`` of ``csrc/<kernel>.cu``'s library (built
    at first use), its argument types declared; every C function of the
    port returns an int (a launcher: the launch's CUDA error).  ``expect``:
    (symbol, value) pairs of C functions of no argument, the kernel's
    constants, each of which must return the wrapper's value; checked
    once, at the first bind."""
    lib, _info = build(kernel)
    for name, want in expect:
        got = bind(kernel, name, ())()
        if got != want:
            raise RuntimeError(f"{kernel}: the kernel's {name} is {got}, "
                               f"the wrapper's {want}")
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


class LaunchCount:
    """A kernel's calls: ``launches`` made outside a CUDA graph's capture,
    ``captured`` recorded into one (nothing runs then: whoever replays the
    graph counts its launches).  :func:`launch` adds one where it launched
    the kernel, and nothing else does."""


def launch_count(kernel: str, holder=None):
    """The launch count of ``csrc/<kernel>.cu``, at 0, registered in
    :data:`COUNTS` under the kernel's name: ``holder`` where given
    (``fused_fft1`` keeps its count on the function), else a new
    :class:`LaunchCount`.  The kernel's module makes it as it loads."""
    count = LaunchCount() if holder is None else holder
    count.launches = count.captured = 0
    COUNTS[kernel] = count
    return count


def raw_stream(device: torch.device) -> int:
    """The handle of the device's current stream, without building a
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(fn, args: tuple, device: torch.device, what: str, count) -> None:
    """Call the C launcher ``fn(*args, stream)`` on the device's current
    stream, with the device current.  It returns the CUDA error of the
    launch (``cudaGetLastError``): anything but 0 raises, and 0 adds the
    launch to ``count``, to ``captured`` during a CUDA graph's capture and
    to ``launches`` outside one (``count`` None: the library's empty
    kernel, which is no operator's)."""
    stream = raw_stream(device)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")
    if count is None:
        return
    if torch.cuda.is_current_stream_capturing():
        count.captured += 1
    else:
        count.launches += 1


def on_device(op: str, device: torch.device, plain, card, *args):
    """``plain(*args)`` on the CPU, ``card(*args)`` on a CUDA device; any
    other device is refused, naming the operator.  There is no fallback
    between the two."""
    if device.type == "cpu":
        return plain(*args)
    if device.type == "cuda":
        return card(*args)
    raise ValueError(f"{op}: unsupported device {device}")


class Streams:
    """The operator of a hand kernel whose card path serves R streams in
    one launch: ``card`` takes each tensor argument with its stream axis in
    front, but the tables at the positions ``shared``, which may come
    without one and then serve every stream, and returns each output with
    its stream axis in front.  ``plain`` is the plain version of one
    stream; ``check`` refuses the arguments of one stream that the
    operator does not take (it looks at no device: ``meta`` reaches it
    under the fake).

    A call is the operator on one stream (the custom operator's body):
    the plain version on a CPU tensor, the card path as one stream of one
    on a CUDA tensor.  :meth:`vmap` is its rule for ``torch.func.vmap``."""

    def __init__(self, op: str, check, plain, card, shared: tuple = ()):
        self.op, self.check, self.plain, self.card = op, check, plain, card
        self.shared = shared

    def _data(self, i: int, x) -> bool:
        return isinstance(x, torch.Tensor) and i not in self.shared

    def __call__(self, *args):
        self.check(*args)
        return on_device(self.op, args[0].device, self.plain, self._one,
                         *args)

    def _one(self, *args):
        out = self.card(*(x[None] if self._data(i, x) else x
                          for i, x in enumerate(args)))
        return out[0] if isinstance(out, torch.Tensor) else tuple(
            o[0] for o in out)

    def vmap(self, info, in_dims, *args):
        """R streams: each batched argument's stream axis moved to the
        front, an unbatched data argument expanded to R streams, an
        unbatched table left as it is; the first stream checked; on the
        card one call of the card path, on the CPU the plain version once
        per stream, stacked."""
        r = info.batch_size
        args = [x.movedim(d, 0) if d is not None
                else x.expand((r,) + tuple(x.shape)) if self._data(i, x)
                else x for i, (x, d) in enumerate(zip(args, in_dims))]
        ours = [d is not None or self._data(i, x)
                for i, (x, d) in enumerate(zip(args, in_dims))]

        def stream(j):
            return [x[j] if b else x for x, b in zip(args, ours)]

        def per_stream(*_):
            outs = [self.plain(*stream(j)) for j in range(r)]
            if isinstance(outs[0], torch.Tensor):
                return torch.stack(outs)
            return tuple(torch.stack(v) for v in zip(*outs))

        self.check(*stream(0))
        out = on_device(self.op, args[0].device, per_stream, self.card,
                        *args)
        return out, 0 if isinstance(out, torch.Tensor) else (0,) * len(out)
