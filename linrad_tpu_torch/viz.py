"""Observable outputs: spectra, waterfalls, meters, stability analysis
(port of linrad_tpu/viz.py, a copy; every array argument may be a
torch tensor on any device, and every result is numpy).

The reference's graphs ARE its metrics (SURVEY.md §5): the wide graph
(fft1/fft2 averages + waterfall, wide_graph.c, fft1_waterfall
fft1.c:115), hires graph (hires_graph.c), baseband graph
(baseb_graph.c), S-meter (meter_graph.c), Allan-deviation graph
(allan_graph.c), cross-channel correlation spectrum and the coherent
oscilloscope.  This module produces the same observables as arrays —
the GUI is replaced by data products (SURVEY.md §7) — plus a PGM/PNG-
free image dump (the gifsave.c:960 analog writes portable graymaps).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .utils.host import to_numpy


@dataclass
class Waterfall:
    """Scrolling dB waterfall from per-step power spectra
    (update_wg_waterf, fft1.c:104)."""

    n_bins: int
    depth: int = 256
    avg_steps: int = 1           # spectra averaged per line (wg settings)
    db_floor: float = -20.0
    db_range: float = 80.0
    _rows: list = field(default_factory=list)
    _acc: np.ndarray | None = None
    _count: int = 0

    def add(self, power: np.ndarray) -> None:
        p = to_numpy(power, np.float64)
        if p.ndim == 2:
            p = p.sum(axis=-1)
        self._acc = p if self._acc is None else self._acc + p
        self._count += 1
        if self._count >= self.avg_steps:
            line = 10 * np.log10(np.maximum(self._acc / self._count,
                                            1e-30))
            self._rows.append(line)
            if len(self._rows) > self.depth:
                self._rows.pop(0)
            self._acc = None
            self._count = 0

    @property
    def array_db(self) -> np.ndarray:
        """(lines, n_bins) float dB, newest last."""
        if not self._rows:
            return np.zeros((0, self.n_bins))
        return np.stack(self._rows)

    def image(self) -> np.ndarray:
        """uint8 intensity image (the waterfall pixels)."""
        db = self.array_db
        x = (db - self.db_floor) / self.db_range
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def spectrum_db(power: np.ndarray, ref: float = 1.0) -> np.ndarray:
    """Averaged spectrum in dB (the wide/hires graph trace)."""
    p = to_numpy(power, np.float64)
    if p.ndim == 2:
        p = p.sum(axis=-1)
    return 10 * np.log10(np.maximum(p / ref, 1e-30))


def s_meter_dbm(baseb_power: float, gain_db: float = 0.0) -> tuple[float,
                                                                   str]:
    """S-meter reading (meter_graph.c + meter.txt averaging): returns
    (dBm, S-unit string) with S9 = -73 dBm, 6 dB per S unit."""
    dbm = 10 * np.log10(max(baseb_power, 1e-30)) + gain_db
    s = 9 + (dbm + 73.0) / 6.0
    if s >= 9:
        label = f"S9+{max(0.0, dbm + 73.0):.0f}dB"
    else:
        label = f"S{max(0.0, s):.0f}"
    return dbm, label


class SMeterLogger:
    """Averaged S-meter logging to a text file — the meter.txt feature
    (meter_graph.c + the MAX_METER_AVGNUM genparm, uivar.c:427): every
    ``avg_steps`` processed steps, one line ``<time_s> <dBm> <S-label>``
    is appended."""

    def __init__(self, path: str, step_seconds: float,
                 avg_steps: int = 10, gain_db: float = 0.0):
        self.path = path
        self.step_seconds = step_seconds
        self.avg_steps = max(1, avg_steps)
        self.gain_db = gain_db
        self._acc = 0.0
        self._n = 0
        self._steps_total = 0
        open(path, "w").close()

    def add(self, baseb_power: float) -> None:
        self._acc += float(baseb_power)
        self._n += 1
        self._steps_total += 1
        if self._n >= self.avg_steps:
            dbm, label = s_meter_dbm(self._acc / self._n, self.gain_db)
            t = self._steps_total * self.step_seconds
            with open(self.path, "a") as f:
                f.write(f"{t:.3f} {dbm:.2f} {label}\n")
            self._acc = 0.0
            self._n = 0


def correlation_spectrum(spec: np.ndarray) -> np.ndarray:
    """Cross-channel correlation spectrum for 2-channel input
    (the optional cross spectrum accumulated in fft1_c, fft1.c:4085):
    complex E{X0 conj(X1)} per bin over the frame batch."""
    spec = to_numpy(spec)
    assert spec.shape[-1] == 2, "needs 2 RF channels"
    return np.mean(spec[..., 0] * np.conj(spec[..., 1]), axis=0)


def allan_deviation(freq_hz: np.ndarray, tau0_s: float,
                    taus: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Overlapping Allan deviation of a frequency series — the
    oscillator-stability analysis of the Allan graph (allan_graph.c).

    freq_hz: fractional or absolute frequency samples at spacing tau0_s.
    Returns (taus, adev)."""
    y = to_numpy(freq_hz, np.float64)
    n = len(y)
    if taus is None:
        ms = []
        m = 1
        while m <= n // 3:
            ms.append(m)
            m *= 2
        ms = np.array(ms)
    else:
        ms = np.maximum(1, (to_numpy(taus) / tau0_s).astype(int))
    out = []
    for m in ms:
        # overlapping estimator: avar = <(ybar_{i+m} - ybar_i)^2>/2
        c = np.cumsum(np.concatenate([[0.0], y]))
        ybar = (c[m:] - c[:-m]) / m
        d = ybar[m:] - ybar[:-m]
        out.append(np.sqrt(0.5 * np.mean(d ** 2)) if len(d) else np.nan)
    return ms * tau0_s, np.array(out)


def oscilloscope_capture(weak: np.ndarray, pwr: np.ndarray,
                         window: int = 512) -> dict:
    """Blanker oscilloscope: capture the strongest event of a block
    (timf2_oscilloscope_* state, blank1.c:869-926)."""
    pwr = to_numpy(pwr)
    k = int(np.argmax(pwr))
    lo = max(0, k - window // 2)
    hi = min(len(pwr), lo + window)
    return {"maxpoint": k, "maxval": float(np.sqrt(pwr[k])),
            "trace": to_numpy(weak[lo:hi]).copy(), "start": lo}


def save_pgm(path: str, image: np.ndarray) -> None:
    """Screen-dump analog (save_screen_image, gifsave.c:960) as a
    portable graymap — dependency-free."""
    img = to_numpy(image, np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def _lzw_encode(data: np.ndarray, min_code_size: int) -> bytes:
    """GIF-variant LZW: emits a clear code first, grows code width up
    to 12 bits, re-clears on dictionary overflow."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code: int, width: int) -> None:
        nonlocal bitbuf, bitcnt
        bitbuf |= code << bitcnt
        bitcnt += width
        while bitcnt >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            bitcnt -= 8

    table = {bytes([i]): i for i in range(clear)}
    next_code = eoi + 1
    width = min_code_size + 1
    emit(clear, width)
    prefix = b""
    for b in data.tobytes():
        cand = prefix + bytes([b])
        if cand in table:
            prefix = cand
            continue
        emit(table[prefix], width)
        if next_code < 4096:
            table[cand] = next_code
            if next_code == (1 << width) and width < 12:
                width += 1
            next_code += 1
        else:
            emit(clear, width)
            table = {bytes([i]): i for i in range(clear)}
            next_code = eoi + 1
            width = min_code_size + 1
        prefix = bytes([b])
    if prefix:
        emit(table[prefix], width)
    emit(eoi, width)
    if bitcnt:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def save_gif(path: str, image: np.ndarray,
             palette: np.ndarray | None = None) -> None:
    """Screen dump as an actual GIF87a (save_screen_image,
    gifsave.c:960) with LZW compression — dependency-free.

    image: (H, W) uint8 palette indices (grayscale levels by default).
    palette: optional (256, 3) uint8 RGB colormap (the reference's
    256-color palette, palette.c); defaults to grayscale."""
    img = np.ascontiguousarray(to_numpy(image, np.uint8))
    assert img.ndim == 2, "expects a (H, W) index image"
    h, w = img.shape
    if palette is None:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pal = to_numpy(palette, np.uint8)
    assert pal.shape == (256, 3), pal.shape
    with open(path, "wb") as f:
        f.write(b"GIF87a")
        # logical screen descriptor: global color table, 8 bits/pixel
        f.write(w.to_bytes(2, "little") + h.to_bytes(2, "little"))
        f.write(bytes([0xF7, 0, 0]))
        f.write(pal.tobytes())
        # image descriptor (no local color table)
        f.write(b"\x2C" + bytes(4))
        f.write(w.to_bytes(2, "little") + h.to_bytes(2, "little"))
        f.write(b"\x00")
        f.write(bytes([8]))                      # LZW min code size
        data = _lzw_encode(img.reshape(-1), 8)
        for i in range(0, len(data), 255):
            chunk = data[i: i + 255]
            f.write(bytes([len(chunk)]) + chunk)
        f.write(b"\x00\x3B")                     # terminator + trailer


def radar_graph_image(tracker, log_floor_db: float = -60.0) -> np.ndarray:
    """The radar graph (make_radar_graph radar.c:422-520) as a data
    product: range lines on the vertical axis, display bins across, dB
    intensity in [0,1].  ``tracker`` is this package's
    weak.radar.RadarTracker; before
    lock the image is empty."""
    avg = tracker.average
    if avg.size == 0:
        return np.zeros((0, 0), np.float32)
    db = 10.0 * np.log10(np.maximum(avg, 1e-30))
    db -= db.max()
    return np.clip(1.0 - db / log_floor_db, 0.0, 1.0).astype(np.float32)
