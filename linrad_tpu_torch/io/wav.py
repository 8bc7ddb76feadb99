"""WAV file ingest/output honouring Linrad's recording formats.

Replaces Linrad's file-input thread and WAV parser (``init_wavread``
reference modesub.c:1022, ``write_wav_header`` modesub.c:146) including
the SDR metadata chunks Linrad understands (reference z_WAV_FORMATS.txt):

- Perseus ``rcvr`` chunk: centre frequency, sampling-rate index, start
  time, attenuator/preamp flags.
- SpectraVue ``auxi`` chunk: start/stop SYSTEMTIME, centre frequency,
  A/D frequency, bandwidth, I/Q DC offset.

Sample formats: 8/16/24/32-bit integer PCM and float32, mono to 4
channels (I/Q x 2 RF channels), matching the formats the reference file
input thread accepts.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class RcvrChunk:
    """Perseus 'rcvr' metadata (z_WAV_FORMATS.txt:1-18)."""

    center_frequency_hz: int = 0
    sampling_rate_idx: int = 0
    time_start: int = 0
    atten_id: int = 0
    adc_presel: int = 0
    adc_preamp: int = 0
    adc_dither: int = 0

    _FMT = "<llLHbbbb16s"

    def pack(self) -> bytes:
        body = struct.pack(self._FMT, self.center_frequency_hz,
                           self.sampling_rate_idx, self.time_start,
                           self.atten_id, self.adc_presel, self.adc_preamp,
                           self.adc_dither, 0, b"\0" * 16)
        return b"rcvr" + struct.pack("<I", len(body)) + body

    @classmethod
    def unpack(cls, body: bytes) -> "RcvrChunk":
        vals = struct.unpack(cls._FMT, body[: struct.calcsize(cls._FMT)])
        return cls(center_frequency_hz=vals[0], sampling_rate_idx=vals[1],
                   time_start=vals[2], atten_id=vals[3], adc_presel=vals[4],
                   adc_preamp=vals[5], adc_dither=vals[6])


@dataclass
class AuxiChunk:
    """SpectraVue 'auxi' metadata (z_WAV_FORMATS.txt:38-55)."""

    center_freq: int = 0
    ad_frequency: int = 0
    if_frequency: int = 0
    bandwidth: int = 0
    iq_offset: int = 0
    start_time: bytes = b"\0" * 16   # raw SYSTEMTIME
    stop_time: bytes = b"\0" * 16

    def pack(self) -> bytes:
        body = (self.start_time + self.stop_time
                + struct.pack("<9I", self.center_freq, self.ad_frequency,
                              self.if_frequency, self.bandwidth,
                              self.iq_offset, 0, 0, 0, 0)
                + b"\0" * 96)
        return b"auxi" + struct.pack("<I", len(body)) + body

    @classmethod
    def unpack(cls, body: bytes) -> "AuxiChunk":
        start_time, stop_time = body[:16], body[16:32]
        vals = struct.unpack("<9I", body[32:68])
        return cls(center_freq=vals[0], ad_frequency=vals[1],
                   if_frequency=vals[2], bandwidth=vals[3],
                   iq_offset=vals[4], start_time=start_time,
                   stop_time=stop_time)


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits: int
    is_float: bool
    n_frames: int
    rcvr: RcvrChunk | None = None
    auxi: AuxiChunk | None = None


def read_wav(path: str, return_iq: bool = True
             ) -> tuple[np.ndarray, WavInfo]:
    """Read a (possibly SDR-tagged) WAV file.

    With ``return_iq`` and an even channel count, consecutive channel
    pairs are combined to complex IQ: output shape (n, channels//2)
    complex64, the layout Linrad's timf1 uses (lsetad.c:1074-1090).
    Otherwise returns float32 (n, channels) scaled like the reference
    (integer PCM kept in native integer units — Linrad works in A/D
    counts, not normalised floats).
    """
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        rcvr = None
        auxi = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"rcvr":
                rcvr = RcvrChunk.unpack(f.read(csize))
            elif cid == b"auxi":
                auxi = AuxiChunk.unpack(f.read(csize))
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        (wformat, nch, rate, _byterate, _align, bits) = struct.unpack(
            "<HHIIHH", fmt[:16])
        is_float = wformat == 3
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0)
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32)
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            x = (raw[:, 0].astype(np.int32)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = ((x << 8) >> 8).astype(np.float32)  # sign-extend
        elif bits == 32 and is_float:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported bit depth {bits}")
        n = x.size // nch
        x = x[: n * nch].reshape(n, nch)
        info = WavInfo(sample_rate=rate, channels=nch, bits=bits,
                       is_float=is_float, n_frames=n, rcvr=rcvr, auxi=auxi)
        if return_iq and nch % 2 == 0:
            iq = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
            return iq, info
        return x, info


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              bits: int = 16, rcvr: RcvrChunk | None = None,
              auxi: AuxiChunk | None = None,
              pcm32: bool = False) -> None:
    """Write PCM or float WAV; complex input is interleaved to I/Q channel
    pairs (the inverse of :func:`read_wav`).  bits=32 writes IEEE float
    (format 3) unless ``pcm32`` selects 32-bit integer PCM (format 1,
    the QS1R capture layout, sim2qs1r.c:224)."""
    if np.iscomplexobj(data):
        if data.ndim == 1:
            data = data[:, None]
        inter = np.empty((data.shape[0], data.shape[1] * 2), np.float32)
        inter[:, 0::2] = data.real
        inter[:, 1::2] = data.imag
        data = inter
    if data.ndim == 1:
        data = data[:, None]
    nch = data.shape[1]
    if bits == 16:
        payload = np.clip(np.round(data), -32768, 32767).astype("<i2"
                                                               ).tobytes()
        wformat, block = 1, 2 * nch
    elif bits == 32 and pcm32:
        payload = np.clip(np.round(data), -(1 << 31),
                          (1 << 31) - 1).astype("<i4").tobytes()
        wformat, block = 1, 4 * nch
    elif bits == 32:
        payload = data.astype("<f4").tobytes()
        wformat, block = 3, 4 * nch
    elif bits == 24:
        ints = np.clip(np.round(data), -(1 << 23), (1 << 23) - 1
                       ).astype(np.int32)
        raw = np.empty((ints.size, 3), np.uint8)
        flat = ints.reshape(-1)
        raw[:, 0] = flat & 0xFF
        raw[:, 1] = (flat >> 8) & 0xFF
        raw[:, 2] = (flat >> 16) & 0xFF
        payload = raw.tobytes()
        wformat, block = 1, 3 * nch
    else:
        raise ValueError(f"unsupported bits {bits}")
    fmt = struct.pack("<HHIIHH", wformat, nch, sample_rate,
                      sample_rate * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if rcvr is not None:
        chunks += rcvr.pack()
    if auxi is not None:
        chunks += auxi.pack()
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE")
        f.write(chunks)
