"""The radar mode's plain reference: Linrad's ``run_radar`` (radar.c:121-520)
over the frames of this package's own fft1.

- :func:`pulse_stats` is radar.c:195-226 as C walks it, one frame at a
  time over a host copy of the power: the peak bin, then the skirt walk to
  each side, a loop that steps while the bin beats its next two
  neighbours and stops at the first that it does not, then the mean power
  outside the skirt (the noise floor) and the peak over it (S/N).  One
  departure, the port's: each walk is bounded at 32 steps (``walk_steps``)
  (radar.c:206-216 loops without a bound).  It also reports how near each
  frame's decisions came to a tie (:data:`TIE`, the comparison's use).
- :class:`RadarTracker` is a frozen copy of the port's tracker
  (``linrad_tpu_torch/weak/radar.py``): the pulse train's lock
  (radar.c:227-345), the scan that adds a decayed window of frames to the
  range x Doppler display after each pulse (update_radar_average,
  radar.c:86-118; make_radar_timeconstant, radar.c:61-84), and the bounded
  history, all in numpy; the display's intensity mapping is left out.
- :class:`PlainRadar` is the radar mode's path, block by block: fft1
  (:mod:`..ops.fft1`, the fused kernel's plain version for
  ``fft1_variant="pallas"``), each frame's power summed over the channels,
  :func:`pulse_stats`, the tracker.

It imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..geometry import derive_geometry
from ..ops.fft1 import FFT1State, FFT1Tables, fft1_step
from ..params import RxParams

# a decision whose two compared powers lie closer than this, relative to
# the larger, is a tie that two correct float32 fft1s may decide apart
# (their powers differ by about 1e-7 relative, rxbench/compare.py)
TIE = 1e-5


def _gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-38)


def walk(row: np.ndarray, k: int, direction: int, steps: int
         ) -> tuple[int, float]:
    """The skirt walk of radar.c:206-216 from bin k: (where it stopped, how
    near its closest decision came to a tie)."""
    n = len(row)
    i = k
    margin = np.inf
    for _ in range(steps):
        a, b = i + direction, i + 2 * direction
        if not 0 <= b <= n - 1:
            break
        beats_a, beats_b = row[i] > row[a], row[i] > row[b]
        ga, gb = _gap(row[i], row[a]), _gap(row[i], row[b])
        if beats_a and beats_b:
            margin = min(margin, ga, gb)
            i = a
            continue
        # the step was refused: by either comparison that failed
        margin = min(margin, max(ga, gb) if not (beats_a or beats_b)
                     else (ga if not beats_a else gb))
        break
    return i, margin


def pulse_stats(power: np.ndarray, walk_steps: int = 32) -> dict:
    """Per frame of ``power`` ((frames, bins) float32): ``peak_bin``,
    ``ston``, ``noise_floor``, and the ties: ``peak_margin`` (the peak over
    the next largest bin) and ``walk_margin`` (the walks' closest
    decision)."""
    f, n = power.shape
    out = {k: np.zeros(f, t) for k, t in (
        ("peak_bin", np.int64), ("ston", np.float64),
        ("noise_floor", np.float64), ("peak_margin", np.float64),
        ("walk_margin", np.float64))}
    for j in range(f):
        row = power[j]
        k = int(np.argmax(row))
        peak = float(row[k])
        rest = np.delete(row, k)
        out["peak_margin"][j] = _gap(peak, float(rest.max())) if len(rest) \
            else np.inf
        ia, ma = walk(row, k, -1, walk_steps)
        ib, mb = walk(row, k, +1, walk_steps)
        ib += 1                        # radar.c:216 "ib++"
        row64 = row.astype(np.float64)
        outside = row64[:ia].sum() + row64[ib:].sum()
        floor = outside / max(n - (ib - ia), 1)
        out["peak_bin"][j] = k
        out["noise_floor"][j] = floor
        out["ston"][j] = peak / max(floor, 1e-30)
        out["walk_margin"][j] = min(ma, mb)
    return out


@dataclass
class RadarParams:
    """The radar-graph parameter block (``rg`` in radar.c), as the port's."""

    time: float = 2.0
    gain: float = 10.0
    zero: float = 0.0
    max_lines: int = 256
    max_bins: int = 64
    min_pulses: int = 10
    lock_after: int = 500
    ston_rel: float = 0.003
    mute_ratio: float = 0.1
    mute_check: bool = True


@dataclass(eq=False)
class RadarTracker:
    """The run_radar state machine (radar.c:121-520) on the host: the
    port's tracker with its display kept as a float32 numpy array."""

    n_bins: int
    frame_time_s: float
    params: RadarParams = field(default_factory=RadarParams)
    bin_hz: float = 0.0

    locked: bool = False
    pulse_sep: int = 0
    pulse_bin: int = 0
    lines: int = 0
    first_bin: int = 0
    last_bin: int = 0
    decayfac: float = 1.0
    update_cnt: int = 0

    def __post_init__(self):
        self._hist_pw: list[np.ndarray] = []
        self._bins: list[int] = []
        self._ston: list[float] = []
        self._floor: list[float] = []
        self._consumed = 0
        self._avg: np.ndarray | None = None
        self._next_scan = 0

    def feed(self, power: np.ndarray, peak_bin, ston, noise_floor) -> None:
        """One step's (frames, bins) power and its frames' statistics."""
        self._hist_pw.append(power)
        self._bins.extend(int(b) for b in peak_bin)
        self._ston.extend(float(s) for s in ston)
        self._floor.extend(float(s) for s in noise_floor)
        if not self.locked:
            self._try_lock()
        if self.locked:
            self._scan_pulses()
        self._trim()

    def _pulse_centers(self, ston: np.ndarray) -> np.ndarray:
        """Frames over 25 dB under the best S/N, grouped into pulses, each
        pulse's middle frame (radar.c:246-270)."""
        ref = float(np.max(ston)) * self.params.ston_rel
        idx = np.flatnonzero(ston > ref)
        if len(idx) == 0:
            return np.array([], int)
        breaks = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[idx[0]], idx[breaks + 1]])
        ends = np.concatenate([idx[breaks], [idx[-1]]])
        return (starts + ends) // 2

    def _try_lock(self) -> None:
        p = self.params
        n_hist = len(self._ston)
        if n_hist < p.lock_after:
            return
        floor = np.array(self._floor)
        centers = self._pulse_centers(np.array(self._ston))
        # a pulse cut by either end of the history is left out
        centers = centers[(centers > 2) & (centers < n_hist - 3)]
        if len(centers) < p.min_pulses:
            return
        if p.mute_check:
            # the receiver is muted while the transmitter is on
            # (radar.c:283-292)
            tx_floor = float(np.mean(floor[centers]))
            all_floor = float(np.mean(floor))
            if all_floor <= 0 or tx_floor / all_floor > p.mute_ratio:
                return
        self.pulse_sep = int(np.median(np.diff(centers)))   # radar.c:296-320
        if self.pulse_sep < 2:
            return
        self.pulse_bin = int(round(np.mean(np.array(self._bins)[centers])))
        self.lines = min(self.pulse_sep + 20, p.max_lines)   # radar.c:324
        k = min(self.n_bins, p.max_bins) // 2                # radar.c:327-340
        first, last = self.pulse_bin - k, self.pulse_bin + k
        if first < 0:
            last -= first
            first = 0
        if last > self.n_bins:
            first += self.n_bins - last
            last = self.n_bins
        self.first_bin, self.last_bin = first, last
        t2 = min(p.time, 5.0)                               # radar.c:61-84
        self.decayfac = float(
            0.368 ** (self.pulse_sep * self.frame_time_s / t2)) \
            if t2 > 0 else 0.0
        self._avg = np.zeros((self.lines, last - first), np.float32)
        self.locked = True
        self._next_scan = self._consumed

    def _scan_pulses(self) -> None:
        """After each pulse whose window of ``lines`` frames is whole: the
        pulse's end (its column's maximum within +-4 frames, then on to 1 %
        of it), 10 frames back, and the window added to the decayed
        display (radar.c:86-118, 346-420)."""
        pw = np.concatenate(self._hist_pw, axis=0) if self._hist_pw \
            else np.zeros((0, self.n_bins), np.float32)
        centers = self._pulse_centers(np.array(self._ston))
        for c in centers:
            if c < self._next_scan - self._consumed:
                continue
            lo, hi = max(c - 4, 0), min(c + 5, len(pw))
            if hi <= lo:
                continue
            ia = lo + int(np.argmax(pw[lo:hi, self.pulse_bin]))
            t1 = pw[ia, self.pulse_bin]
            while ia + 1 < len(pw) and 0.01 * t1 < pw[ia, self.pulse_bin]:
                ia += 1
            start = ia - 10
            if start < 0:
                # the window's head has left the history: skip the pulse
                self._next_scan = self._consumed + c + max(
                    self.pulse_sep // 2, 1)
                continue
            if start + self.lines > len(pw):
                continue                   # not whole yet: next block
            self._avg = self._avg * np.float32(self.decayfac) + pw[
                start:start + self.lines, self.first_bin:self.last_bin]
            self.update_cnt += 1
            self._next_scan = self._consumed + c + max(
                self.pulse_sep // 2, 1)

    def _trim(self) -> None:
        """Keep about 4 pulse periods of history (radar.c:144), dropping
        only frames already scanned."""
        keep = max(4 * max(self.pulse_sep, 1) + self.lines + 64,
                   self.params.lock_after + 64)
        drop = sum(len(a) for a in self._hist_pw) - keep
        if drop <= 0:
            return
        drop = min(drop, max(self._next_scan - self._consumed - 16, 0))
        while drop > 0 and self._hist_pw:
            blk = self._hist_pw[0]
            n = min(len(blk), drop)
            if n == len(blk):
                self._hist_pw.pop(0)
            else:
                self._hist_pw[0] = blk[n:]
            self._consumed += n
            del self._bins[:n]
            del self._ston[:n]
            del self._floor[:n]
            drop -= n

    @property
    def average(self) -> np.ndarray:
        """The display (lines x display bins)."""
        if self._avg is None:
            return np.zeros((0, 0), np.float32)
        return self._avg

    def echo_peak(self, tx_guard_lines: int = 4) -> tuple[int, int]:
        """The strongest display cell off the transmitter's rows: (its line
        after the pulse, modulo the pulse separation; its bins off the
        pulse's)."""
        avg = self.average
        if avg.size == 0:
            return (0, 0)
        prof = avg.sum(axis=1)
        tx_line = int(np.argmax(prof > 0.5 * prof.max()))
        masked = avg.copy()
        for p0 in range(tx_line, self.lines, max(self.pulse_sep, 1)):
            masked[max(p0 - tx_guard_lines, 0):p0 + tx_guard_lines + 1] = 0.0
        line, b = np.unravel_index(int(np.argmax(masked)), masked.shape)
        return ((int(line) - tx_line) % max(self.pulse_sep, 1),
                int(b) - (self.pulse_bin - self.first_bin))


class PlainRadar:
    """The radar mode on ``device``, block by block: this package's fft1,
    the frames' power and statistics, the tracker."""

    def __init__(self, params: RxParams, radar: RadarParams, device):
        self.device = torch.device(device)
        self.params = params
        self.geo = geo = derive_geometry(params)
        self.tables = FFT1Tables.create(geo, self.device)
        self.state = FFT1State.create(geo, self.device)
        self.tracker = RadarTracker(
            n_bins=geo.fft1_size,
            frame_time_s=geo.fft1_new_points / geo.timf1_sampling_speed,
            params=radar, bin_hz=geo.timf1_sampling_speed / geo.fft1_size)

    def feed(self, block: torch.Tensor) -> dict:
        """One (samples_per_step, C) complex64 block: its frames' power,
        statistics and ties, and the tracker after it."""
        self.state, spec, _ = fft1_step(
            self.geo, self.tables, self.state, block,
            self.params.fft_avg1num, variant=self.params.fft1_variant)
        power = (spec.abs() ** 2).sum(-1).cpu().numpy()
        stats = pulse_stats(power)
        self.tracker.feed(power, stats["peak_bin"], stats["ston"],
                          stats["noise_floor"])
        return {"power": power, **stats}
