"""Linrad-style raw recordings with 16/18/24-bit packing.

The reference's raw recorder (``write_raw_file`` rxin.c:628) writes the
timf1 byte stream headerless (16-bit) or packed (18/24-bit via
``compress_rawdat`` getiq.s:35-37); format parameters live in companion
files.  Here the same payloads get a small self-describing header
(magic + rate/channels/bits/centre frequency) so a recording is a single
file; ``read_raw(..., headerless=...)`` ingests reference-style
headerless payloads too.  Packing runs through the native runtime
(runtime/lrt.cpp) with numpy fallback."""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from .. import runtime

MAGIC = b"LTPURAW1"


@dataclass
class RawInfo:
    sample_rate: int
    channels: int          # complex IQ channels
    bits: int              # 16 / 18 / 24
    center_freq_hz: float = 0.0


def write_raw(path: str, iq: np.ndarray, sample_rate: int, bits: int = 18,
              center_freq_hz: float = 0.0,
              full_scale: float = 1.0) -> None:
    """Write complex IQ to a packed raw file.

    full_scale: the float amplitude mapped to int32 full scale."""
    if iq.ndim == 1:
        iq = iq[:, None]
    info = {"sample_rate": int(sample_rate), "channels": iq.shape[1],
            "bits": int(bits), "center_freq_hz": float(center_freq_hz),
            "full_scale": float(full_scale)}
    inter = np.empty((iq.shape[0], iq.shape[1] * 2), np.float64)
    inter[:, 0::2] = iq.real
    inter[:, 1::2] = iq.imag
    scale = (2 ** 31 - 1) / full_scale
    ints = np.clip(np.round(inter.reshape(-1) * scale),
                   -(2 ** 31), 2 ** 31 - 1).astype(np.int64
                                                   ).astype(np.int32)
    if bits == 16:
        payload = (ints >> 16).astype(np.int16).tobytes()
    elif bits == 18:
        pad = (-len(ints)) % 4
        if pad:
            ints = np.concatenate([ints, np.zeros(pad, np.int32)])
        payload = runtime.pack18(ints).tobytes()
    elif bits == 24:
        payload = runtime.pack24(ints).tobytes()
    else:
        raise ValueError(f"bits must be 16/18/24, got {bits}")
    hdr = json.dumps(info).encode()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", len(hdr)) + hdr)
        f.write(payload)


def read_raw(path: str, headerless: RawInfo | None = None,
             full_scale: float = 1.0) -> tuple[np.ndarray, RawInfo]:
    """Read a packed raw file back to complex64 IQ in float units."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head == MAGIC:
            (hlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(hlen))
            info = RawInfo(sample_rate=meta["sample_rate"],
                           channels=meta["channels"], bits=meta["bits"],
                           center_freq_hz=meta["center_freq_hz"])
            full_scale = meta.get("full_scale", full_scale)
        else:
            if headerless is None:
                raise ValueError(
                    f"{path}: no LTPURAW1 header; pass headerless=RawInfo")
            info = headerless
            f.seek(0)
        payload = f.read()
    if info.bits == 16:
        ints = np.frombuffer(payload, "<i2").astype(np.int32) << 16
    elif info.bits == 18:
        ints = runtime.expand18(np.frombuffer(payload, np.uint8))
    elif info.bits == 24:
        ints = runtime.expand24(np.frombuffer(payload, np.uint8))
    else:
        raise ValueError(f"unsupported bits {info.bits}")
    scale = full_scale / (2 ** 31 - 1)
    x = ints.astype(np.float64) * scale
    n = len(x) // (2 * info.channels)
    x = x[: n * 2 * info.channels].reshape(n, 2 * info.channels)
    iq = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    return iq, info
