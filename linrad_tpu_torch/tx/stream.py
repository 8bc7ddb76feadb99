"""Streamed transmit path: file -> DAC streaming with delay accounting
(port of linrad_tpu/tx/stream.py).

A re-design of the reference's streaming transmit side:

* ``disk2tx`` (tx.c:211-495): stream a .wav file through a power-of-two
  output ring in fixed DAC blocks, looping at EOF — the reference
  zero-fills the short block and rewinds with ``fsetpos``
  (tx.c:420-428) — and injects the TX pilot tone into every output
  block (tx.c:409-413).
* ``tx_total_delay`` / ``tx_ssb_buftim`` (tx.c:501-600): total
  microphone-to-antenna latency = the sum over pipeline stages of
  buffered-sample counts, each scaled to seconds by its stage's own
  sample rate (the reference divides by resampling ratios and finally
  by ``ui.tx_ad_speed``; we keep per-stage rates explicit).

The reference spreads this state over five ring-buffer pointer pairs
(``mictimf``, ``mic_key``, ``micfft``/``cliptimf``, ``clipfft``/
``alctimf``, ``txout``) updated from soundcard callbacks.  Here each
stage is an explicit :class:`StageBuffer` with monotone written/read
counters, the per-block DSP (pilot add, SSB processing, modulation,
rational resampling) flows block-by-block with static shapes, and the
"DAC" is a sink callable so the same streamer drives files, network
taps, or device queues.

In this package the rational resampler of :class:`SsbTxStreamer` runs on
a torch device, the card unless the caller names another, as the JAX
package's runs on its default device; the rings, the speech processor,
the modulator and the delay model stay host numpy, as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.wav import read_wav
from ..ops.resample import Resampler
from ..utils.host import to_numpy
from .modulate import StreamingSSB
from .ssbproc import SSBProcessor


class TxFormatError(ValueError):
    """Raised when a TX source file disagrees with the TX setup (the
    header checks of disk2tx, tx.c:286-305)."""


@dataclass
class StageBuffer:
    """One pipeline stage's buffered-data accounting.

    The reference computes occupancy as ``(pa-px+bufsiz)&mask`` for each
    ring (tx.c:510-534); with monotone counters that is simply
    ``written - read``.
    """

    name: str
    rate_hz: float
    written: int = 0
    read: int = 0

    @property
    def occupancy(self) -> int:
        return self.written - self.read

    @property
    def delay_s(self) -> float:
        return self.occupancy / self.rate_hz if self.rate_hz > 0 else 0.0


class WavTxSource:
    """Looping block reader for a TX .wav file (disk2tx's file side).

    Validates rate/channel agreement with the TX setup like the header
    checks of tx.c:286-305, then serves fixed-size blocks forever:
    at EOF the remainder of the block is zero-filled and the file
    position rewinds to the data start (tx.c:420-428).
    """

    def __init__(self, path: str, expect_rate: int | None = None,
                 expect_channels: int | None = None, iq: bool = True):
        data, info = read_wav(path, return_iq=iq)
        if expect_rate is not None and info.sample_rate != expect_rate:
            raise TxFormatError(
                f"sampling speed {info.sample_rate} does not agree with "
                f"the TX setup ({expect_rate})")     # tx.c:296-303
        if expect_channels is not None and info.channels != expect_channels:
            raise TxFormatError(
                f"channel count {info.channels} does not agree with the "
                f"TX setup ({expect_channels})")      # tx.c:286-293
        if data.ndim == 2 and data.shape[1] == 1:
            data = data[:, 0]
        self.data = data
        self.info = info
        self.pos = 0
        self.loops = 0

    def read_block(self, n: int) -> np.ndarray:
        out = np.zeros((n,) + self.data.shape[1:], self.data.dtype)
        take = min(n, len(self.data) - self.pos)
        out[:take] = self.data[self.pos: self.pos + take]
        if take < n:
            # zero-fill and rewind, exactly the EOF handling of
            # tx.c:420-428 (the partial block plays out padded; the next
            # block restarts from the top of the file)
            self.pos = 0
            self.loops += 1
        else:
            self.pos += take
        return out


@dataclass
class TxDelayModel:
    """tx_total_delay (tx.c:501-545) over explicit stages."""

    stages: list[StageBuffer] = field(default_factory=list)
    device_out_samples: int = 0      # lir_tx_output_samples() analog
    device_rate_hz: float = 0.0

    def add(self, stage: StageBuffer) -> StageBuffer:
        self.stages.append(stage)
        return stage

    def total_delay(self) -> float:
        t = sum(s.delay_s for s in self.stages)
        if self.device_rate_hz > 0:
            t += self.device_out_samples / self.device_rate_hz
        return t


class TxStreamer:
    """disk2tx: stream IQ blocks from a source into a DAC sink through a
    power-of-two ring with pilot-tone injection (tx.c:211-495).

    The ring is primed to ``ring_blocks - 2`` blocks before output
    starts (the reference fills until ``txout_pa >= bufsize-2*blksize``,
    tx.c:392-398), then each :meth:`step` plays the oldest block (pilot
    added at play-out time, as tx.c:409-413 does) and refills one block
    from the source, so the ring occupancy — and hence the reported
    delay — stays constant in steady state.
    """

    def __init__(self, source: WavTxSource, fs: float, block: int,
                 ring_blocks: int = 8, pilot_hz: float = 0.0,
                 pilot_level: float = 0.0):
        if ring_blocks & (ring_blocks - 1):
            raise ValueError("ring_blocks must be a power of two")
        if ring_blocks < 4:
            raise ValueError("ring_blocks must be >= 4 (the reference "
                             "primes bufsize-2*blksize, tx.c:392-398)")
        self.source = source
        self.fs = fs
        self.block = block
        self.ring_blocks = ring_blocks
        self._ring: list[np.ndarray] = []
        self.pilot_hz = pilot_hz
        self.pilot_level = pilot_level
        self._played = 0                       # samples, for pilot phase
        self.delay = TxDelayModel(device_rate_hz=fs)
        self.txout = self.delay.add(StageBuffer("txout", fs))
        while len(self._ring) < ring_blocks - 2:
            self._ring.append(self.source.read_block(block))
            self.txout.written += block

    def _pilot(self, n: int) -> np.ndarray:
        t = self._played + np.arange(n, dtype=np.float64)
        return (self.pilot_level
                * np.exp(2j * np.pi * self.pilot_hz / self.fs * t)
                ).astype(np.complex64)

    def step(self, sink) -> None:
        """Play one block, refill one block."""
        blk = self._ring.pop(0)
        if self.pilot_level != 0.0:
            blk = blk + self._pilot(len(blk))
        sink(blk)
        self.txout.read += self.block
        self._played += self.block
        self._ring.append(self.source.read_block(self.block))
        self.txout.written += self.block

    def run(self, n_blocks: int, sink) -> None:
        for _ in range(n_blocks):
            self.step(sink)

    def total_delay(self) -> float:
        return self.delay.total_delay()


class SsbTxStreamer:
    """Live SSB transmit: mic audio -> speech processor -> SSB modulator
    -> rational resampler -> DAC, with tx_total_delay-style accounting.

    The reference's SSB path buffers at three rates (mic at
    ``tx_ad_speed``, the speech processor's internal rings at reduced
    rates, the output at ``tx_da_speed``; tx_ssb_buftim tx.c:548-600).
    Here the processor works in whole blocks, so the per-stage
    occupancies are the not-yet-consumed mic samples, the processor's
    overlap tail, the resampler history, and the output ring.

    device: where the resampler runs ("cuda", "cuda:1", "cpu"); the
    default needs a CUDA device.  Each pumped block goes there and its
    resampled output comes back to the host ring.
    """

    def __init__(self, fs_ad: float, fs_da: float, block: int,
                 proc: SSBProcessor | None = None, usb: bool = True, *,
                 device="cuda"):
        self.fs_ad = fs_ad
        self.fs_da = fs_da
        self.block = block
        self.proc = proc or SSBProcessor(fs_ad, block=block)
        if self.proc.block != block:
            raise ValueError("speech-processor block must match stream")
        self.usb = usb
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SsbTxStreamer: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.resampler = Resampler(fs_ad, fs_da, block, channels=1,
                                   device=self.device,
                                   dtype=torch.complex64)
        self._rs_state = self.resampler.init_state()
        self.delay = TxDelayModel(device_rate_hz=fs_da)
        self.mic = self.delay.add(StageBuffer("mictimf", fs_ad))
        self.spproc = self.delay.add(StageBuffer("spproc", fs_ad))
        self.txout = self.delay.add(StageBuffer("txout", fs_da))
        self._mic_buf = np.zeros(0, np.float32)
        self._out_ring: list[np.ndarray] = []
        self._ssb = StreamingSSB(block, usb=usb)
        # the speech processor permanently holds half a block of sin^2
        # overlap tail, and the streaming Hilbert modulator another half
        # block (report both as buffered data like tx_ssb_buftim's
        # micfft/cliptimf terms, tx.c:548-600)
        self.spproc.written += block // 2 + self._ssb.delay_samples

    def push_mic(self, audio: np.ndarray) -> None:
        """Mic samples arrive (the PortAudio input callback side)."""
        self._mic_buf = np.concatenate(
            [self._mic_buf, to_numpy(audio, np.float32)])
        self.mic.written += len(audio)

    def pump(self) -> None:
        """Process as many whole blocks as the mic buffer holds."""
        while len(self._mic_buf) >= self.block:
            x = self._mic_buf[: self.block]
            self._mic_buf = self._mic_buf[self.block:]
            self.mic.read += self.block
            self.spproc.written += self.block
            audio = self.proc.process(x)
            iq = self._ssb.process(audio)
            self.spproc.read += self.block
            x_dev = torch.from_numpy(iq[:, None].astype(np.complex64))
            self._rs_state, out = self.resampler(
                self._rs_state, x_dev.to(self.device))
            out = to_numpy(out)[:, 0]
            self._out_ring.append(out)
            self.txout.written += len(out)

    def pop_dac(self) -> np.ndarray | None:
        """The DAC drains one resampled block (lir_tx_dawrite side)."""
        if not self._out_ring:
            return None
        out = self._out_ring.pop(0)
        self.txout.read += len(out)
        return out

    def total_delay(self) -> float:
        return self.delay.total_delay()
