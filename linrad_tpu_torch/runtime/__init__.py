"""Native runtime bindings (ctypes over runtime/lrt.cpp).

The reference implements its runtime layer (raw packing getiq.s /
csplit.c, buffer discipline z_BUFFERS.txt, conversion simdasm.s) in
C/assembly; this package builds the C++ equivalent on first use with
g++ into ``build/linrad_tpu_torch/`` under the repository root (named by
a hash of the source, never into the package directory) and falls back
to numpy implementations and a Python reader thread when no compiler is
available.  All converters are exact against the numpy fallbacks.  The
module is this package's own copy of the JAX package's
``runtime/__init__.py``; only the place of the built library differs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "lrt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "linrad_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"liblrt_{digest[:12]}.so"


def _build(so: Path) -> bool:
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded native library, or None (numpy fallback mode)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _lib_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        lib.lrt_pack18.argtypes = [p, p, i64]
        lib.lrt_expand18.argtypes = [p, p, i64]
        lib.lrt_pack24.argtypes = [p, p, i64]
        lib.lrt_expand24.argtypes = [p, p, i64]
        lib.lrt_i16_to_f32.argtypes = [p, p, i64, ctypes.c_float]
        lib.lrt_i32_to_f32.argtypes = [p, p, i64, ctypes.c_float]
        lib.lrt_ring_create.argtypes = [i64]
        lib.lrt_ring_create.restype = p
        lib.lrt_ring_destroy.argtypes = [p]
        lib.lrt_ring_close.argtypes = [p]
        lib.lrt_ring_fill.argtypes = [p]
        lib.lrt_ring_fill.restype = i64
        lib.lrt_ring_write.argtypes = [p, p, i64]
        lib.lrt_ring_write.restype = i64
        lib.lrt_ring_read.argtypes = [p, p, i64]
        lib.lrt_ring_read.restype = i64
        lib.lrt_prefetch_start.argtypes = [ctypes.c_char_p, i64, i64, p]
        lib.lrt_prefetch_start.restype = p
        lib.lrt_prefetch_join.argtypes = [p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# packing (18-bit format of csplit.c / getiq.s)
# ---------------------------------------------------------------------------

def pack18(samples: np.ndarray) -> np.ndarray:
    """int32 samples -> packed 18-bit bytes (9 bytes per 4 samples)."""
    x = np.ascontiguousarray(samples, np.int32)
    assert len(x) % 4 == 0
    out = np.empty(len(x) // 4 * 9, np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.lrt_pack18(_ptr(x), _ptr(out), len(x))
        return out
    v = x.view(np.uint32).reshape(-1, 4)
    g = out.reshape(-1, 9)
    g[:, 0:8:2] = ((v >> 16) & 0xFF).astype(np.uint8)
    g[:, 1:8:2] = (v >> 24).astype(np.uint8)
    bits = ((v >> 14) & 3).astype(np.uint8)
    # sample 0 at bits 7-6 (csplit.c expand order)
    g[:, 8] = ((bits[:, 0] << 6) | (bits[:, 1] << 4) | (bits[:, 2] << 2)
               | bits[:, 3])
    return out


def expand18(packed: np.ndarray) -> np.ndarray:
    """Packed 18-bit bytes -> int32 with the reference's half-bit dither
    (csplit.c:22-30: bit 13 set so the truncation has no DC bias)."""
    b = np.ascontiguousarray(packed, np.uint8)
    assert len(b) % 9 == 0
    n = len(b) // 9 * 4
    out = np.empty(n, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.lrt_expand18(_ptr(b), _ptr(out), n)
        return out
    g = b.reshape(-1, 9)
    v = np.zeros((len(g), 4), np.uint32)
    m = g[:, 8].astype(np.uint32)
    for k in range(4):
        two = ((m << (2 * k)) & 0xC0) << 8
        v[:, k] = (two | 0x2000
                   | (g[:, 2 * k].astype(np.uint32) << 16)
                   | (g[:, 2 * k + 1].astype(np.uint32) << 24))
    return v.reshape(-1).view(np.int32).copy()


def pack24(samples: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(samples, np.int32)
    out = np.empty(len(x) * 3, np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.lrt_pack24(_ptr(x), _ptr(out), len(x))
        return out
    v = x.view(np.uint32)
    o = out.reshape(-1, 3)
    o[:, 0] = (v >> 8) & 0xFF
    o[:, 1] = (v >> 16) & 0xFF
    o[:, 2] = (v >> 24) & 0xFF
    return out


def expand24(packed: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(packed, np.uint8)
    n = len(b) // 3
    out = np.empty(n, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.lrt_expand24(_ptr(b), _ptr(out), n)
        return out
    g = b.reshape(-1, 3).astype(np.uint32)
    v = (g[:, 0] << 8) | (g[:, 1] << 16) | (g[:, 2] << 24)
    return v.view(np.int32).copy()


def i16_to_f32(x: np.ndarray, scale: float = 1.0) -> np.ndarray:
    a = np.ascontiguousarray(x, np.int16)
    out = np.empty(len(a), np.float32)
    lib = get_lib()
    if lib is not None:
        lib.lrt_i16_to_f32(_ptr(a), _ptr(out), len(a),
                           ctypes.c_float(scale))
        return out
    return (a.astype(np.float32) * scale)


# ---------------------------------------------------------------------------
# ring buffer + prefetcher
# ---------------------------------------------------------------------------

class Ring:
    """SPSC byte ring (native when available, queue fallback)."""

    def __init__(self, size: int):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.lrt_ring_create(size)
        else:
            import queue
            self._q = queue.Queue()
            self._closed = False

    def write(self, data: bytes) -> int:
        if self._lib is not None:
            buf = np.frombuffer(data, np.uint8)
            return self._lib.lrt_ring_write(self._h, _ptr(buf), len(buf))
        self._q.put(bytes(data))
        return len(data)

    def read(self, n: int) -> bytes:
        if self._lib is not None:
            out = np.empty(n, np.uint8)
            got = self._lib.lrt_ring_read(self._h, _ptr(out), n)
            return out[:got].tobytes()
        chunks = []
        got = 0
        while got < n:
            try:
                c = self._q.get(timeout=0.1)
            except Exception:
                if self._closed:
                    break
                continue
            chunks.append(c)
            got += len(c)
        data = b"".join(chunks)
        extra = data[n:]
        if extra:
            self._q.queue.appendleft(extra)
        return data[:n]

    def close(self):
        if self._lib is not None:
            self._lib.lrt_ring_close(self._h)
        else:
            self._closed = True

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.lrt_ring_destroy(self._h)
        except Exception:
            pass


class FilePrefetcher:
    """Background file reader feeding a Ring — the replacement for the
    reference's file-input thread (THREAD_RX_FILE_INPUT, SURVEY.md §3.5)
    so disk I/O overlaps device compute.  With the native library the
    whole disk -> ring path is a C++ thread (off the GIL); otherwise a
    Python thread."""

    def __init__(self, path: str, block_bytes: int,
                 ring_bytes: int = 1 << 24, offset: int = 0):
        self.ring = Ring(ring_bytes)
        self.block_bytes = block_bytes
        self._lib = get_lib()
        self._h = None
        if self._lib is not None and self.ring._lib is not None:
            self._h = self._lib.lrt_prefetch_start(
                path.encode(), offset, block_bytes, self.ring._h)
        else:
            self._t = threading.Thread(target=self._run,
                                       args=(path, offset), daemon=True)
            self._t.start()

    def _run(self, path: str, offset: int):
        with open(path, "rb") as f:
            f.seek(offset)
            while True:
                data = f.read(self.block_bytes)
                if not data:
                    break
                self.ring.write(data)
        self.ring.close()

    def read_block(self) -> bytes:
        return self.ring.read(self.block_bytes)

    def __del__(self):
        try:
            if self._h is not None:
                self.ring.close()           # unblock the writer
                self._lib.lrt_prefetch_join(self._h)
                self._h = None
        except Exception:
            pass
