"""Web GUI server — the reference's embryonic HTTP interface rebuilt as
a data-product server (port of linrad_tpu/io/httpd.py; the receiver's
outputs may lie on the card and are copied to the host per step).

Reference: ``html_server`` (html_server.c:67/196) serves ``web_gui.html``
and streams waterfall lines + demodulated audio chunks over TCP;
httpd.c:153 is the socket loop; hmain.c:331 is the standalone prototype.

Here the same capability is a :class:`WebGui` observer registered as a
Receiver ``"block"`` hook (the users_*.c surface): every processed step
feeds a scrolling waterfall, the latest spectrum trace, an S-meter and a
bounded audio ring, and a stdlib ``ThreadingHTTPServer`` exposes them:

    ``GET /``              the embedded HTML page (polls the endpoints)
    ``GET /waterfall.bmp`` current waterfall as an 8-bit grayscale BMP
    ``GET /spectrum.json`` latest averaged spectrum trace (dB)
    ``GET /status.json``   step count, S-meter, tuned frequency
    ``GET /audio.wav``     captured audio so far as a complete WAV
    ``GET /audio.stream``  live chunked int16 audio (the reference's
                           audio-chunk stream, html_server.c:196)

No third-party dependencies: BMP and WAV are written by hand, the
server is ``http.server``.  All shared state is guarded by one lock —
the DSP thread calls :meth:`WebGui.__call__`, server threads read.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import viz
from ..utils.host import to_numpy


def grayscale_bmp(image: np.ndarray) -> bytes:
    """Encode a (rows, cols) uint8 image as an 8-bpp grayscale BMP."""
    img = to_numpy(image, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected 2-D image, got {img.shape}")
    rows, cols = img.shape if img.size else (1, 1)
    if img.size == 0:
        img = np.zeros((1, 1), np.uint8)
    pad = (-cols) % 4
    # bottom-up pixel rows, each padded to a 4-byte boundary
    body = b"".join(bytes(img[r]) + b"\0" * pad
                    for r in range(rows - 1, -1, -1))
    palette = b"".join(struct.pack("<BBBB", g, g, g, 0)
                       for g in range(256))
    off = 14 + 40 + len(palette)
    header = struct.pack("<2sIHHI", b"BM", off + len(body), 0, 0, off)
    dib = struct.pack("<IiiHHIIiiII", 40, cols, rows, 1, 8, 0,
                      len(body), 2835, 2835, 256, 0)
    return header + dib + palette + body


def _wav_bytes(audio: np.ndarray, rate: int) -> bytes:
    """int16 mono/stereo WAV in memory."""
    x = to_numpy(audio)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    nch = x.shape[1] if x.size else 1
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm),
                      b"WAVE", b"fmt ", 16, 1, nch, rate,
                      rate * 2 * nch, 2 * nch, 16, b"data", len(pcm))
    return hdr + pcm


_PAGE = """<!doctype html>
<html><head><title>linrad_tpu</title><style>
body{background:#000;color:#0c0;font-family:monospace}
img{image-rendering:pixelated;width:100%}
</style></head><body>
<h3>linrad_tpu web gui</h3>
<div id="status"></div>
<img id="wf" src="/waterfall.bmp">
<audio controls src="/audio.stream"></audio>
<script>
setInterval(async () => {
  document.getElementById('wf').src = '/waterfall.bmp?t=' + Date.now();
  const s = await (await fetch('/status.json')).json();
  document.getElementById('status').textContent =
    `step ${s.steps}  ${s.s_meter}  ${s.tuned_hz.toFixed(1)} Hz`;
}, 500);
</script></body></html>"""


class WebGui:
    """Receiver observer + HTTP server (the web_gui.html capability).

    Attach with ``gui.attach(receiver)`` (or pass as a ``"block"`` hook)
    and call :meth:`serve`.  ``audio_keep_s`` bounds the snapshot ring;
    live listeners get everything from the moment they connect.
    """

    def __init__(self, audio_rate: int = 48_000, n_bins: int | None = None,
                 depth: int = 256, audio_keep_s: float = 30.0):
        self.audio_rate = int(audio_rate)
        self.audio_keep = int(audio_keep_s * audio_rate)
        self._lock = threading.Lock()
        self._wf: viz.Waterfall | None = (
            viz.Waterfall(n_bins=n_bins, depth=depth)
            if n_bins is not None else None)
        self._depth = depth
        self._spectrum: np.ndarray = np.zeros(0)
        self._audio: list[np.ndarray] = []
        self._audio_len = 0
        self._steps = 0
        self._meter = (float("-inf"), "S0")
        self._tuned_hz = 0.0
        self._listeners: list[queue.Queue] = []
        self._httpd: ThreadingHTTPServer | None = None

    # ---- observer side -------------------------------------------------

    def attach(self, receiver) -> None:
        receiver.add_hook("block", self)
        rate = (getattr(receiver, "audio_out_rate", None)
                or getattr(getattr(receiver, "geo", None),
                           "baseband_sampling_speed", None))
        if rate:
            self.audio_rate = int(round(rate))

    def __call__(self, receiver, out) -> None:
        """Receiver 'block' hook: ingest one step's outputs."""
        power = getattr(out, "fft2_power", None)
        if power is None:
            power = getattr(out, "fft1_power", None)
        audio = to_numpy(out.audio) if out.audio is not None else None
        with self._lock:
            self._steps += 1
            if receiver is not None:
                try:
                    self._tuned_hz = float(receiver.tuned_hz)
                except Exception:
                    pass
            if power is not None:
                p = to_numpy(power, np.float64)
                if p.ndim == 2:          # (bins, channels)
                    p = p.sum(axis=-1)
                if self._wf is None or self._wf.n_bins != p.shape[0]:
                    self._wf = viz.Waterfall(n_bins=p.shape[0],
                                             depth=self._depth)
                self._wf.add(p)
                self._spectrum = viz.spectrum_db(p)
            if audio is not None and audio.size:
                self._meter = viz.s_meter_dbm(
                    float(np.mean(np.square(audio))))
                self._audio.append(audio)
                self._audio_len += audio.shape[0]
                while (self._audio_len - self._audio[0].shape[0]
                       >= self.audio_keep):
                    self._audio_len -= self._audio[0].shape[0]
                    self._audio.pop(0)
                pcm = np.clip(audio.reshape(audio.shape[0], -1),
                              -1.0, 1.0)
                chunk = (pcm * 32767.0).astype("<i2").tobytes()
                for q in list(self._listeners):
                    try:
                        q.put_nowait(chunk)
                    except queue.Full:
                        pass

    # ---- snapshot accessors (server side) ------------------------------

    def waterfall_bmp(self) -> bytes:
        with self._lock:
            img = (self._wf.image() if self._wf is not None
                   else np.zeros((1, 1), np.uint8))
        return grayscale_bmp(img)

    def spectrum(self) -> list[float]:
        with self._lock:
            return [float(v) for v in self._spectrum]

    def status(self) -> dict:
        with self._lock:
            dbm, label = self._meter
            return {"steps": self._steps,
                    "s_meter": label,
                    "s_meter_dbm": dbm,
                    "tuned_hz": self._tuned_hz,
                    "audio_rate": self.audio_rate,
                    "audio_samples": self._audio_len}

    def audio_wav(self) -> bytes:
        with self._lock:
            audio = (np.concatenate(self._audio, axis=0)
                     if self._audio else np.zeros((0, 1), np.float32))
        return _wav_bytes(audio, self.audio_rate)

    def _subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=256)
        with self._lock:
            self._listeners.append(q)
        return q

    def _unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._listeners:
                self._listeners.remove(q)

    # ---- server --------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the HTTP server on a daemon thread; returns the bound
        port (``port=0`` picks a free one)."""
        gui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/":
                    self._reply(_PAGE.encode(), "text/html")
                elif path == "/waterfall.bmp":
                    self._reply(gui.waterfall_bmp(), "image/bmp")
                elif path == "/spectrum.json":
                    self._reply(json.dumps(
                        {"db": gui.spectrum()}).encode(),
                        "application/json")
                elif path == "/status.json":
                    self._reply(json.dumps(gui.status()).encode(),
                                "application/json")
                elif path == "/audio.wav":
                    self._reply(gui.audio_wav(), "audio/wav")
                elif path == "/audio.stream":
                    self._stream_audio()
                else:
                    self.send_error(404)

            def _stream_audio(self):
                # endless WAV: header with max size, then live chunks
                q = gui._subscribe()
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.end_headers()
                    hdr = _wav_bytes(np.zeros((0, 1)), gui.audio_rate)
                    big = struct.pack("<I", 0xFFFFFFF0)
                    self.wfile.write(hdr[:4] + big + hdr[8:40] + big)
                    while True:
                        try:
                            chunk = q.get(timeout=10.0)
                        except queue.Empty:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    gui._unsubscribe(q)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        t = threading.Thread(target=self._httpd.serve_forever,
                             daemon=True, name="linrad-webgui")
        t.start()
        return self._httpd.server_address[1]

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
