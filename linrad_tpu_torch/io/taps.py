"""Stage-boundary streaming taps — distributed operation (port of
linrad_tpu/io/taps.py).

The equivalent of Linrad's network layer (reference network.c,
z_NETWORK.txt, SURVEY.md §2.6): a master exports any tap point of the
pipeline — RAW16/RAW18/RAW24 (input), FFT1, TIMF2, FFT2, BASEB,
BASEBRAW — over UDP multicast; slaves ingest a tap as *their* input, so
the DSP pipeline can split across machines at stage boundaries.

Wire format follows NET_RX_STRUCT (reference globdef.h:1282-1294): a
packet header carrying (passband_center, time, userx_freq, ptr,
block_no, userx_no, passband_direction) + a fixed payload.  Block
numbers let receivers detect gaps and resynchronise (the loss tolerance
of thread_rx_raw_netinput, network.c:810).

Beside the multicast groups, a sender and a receiver of this package
can meet at one unicast address instead (``dest=`` and ``bind=``, for
example on 127.0.0.1), where no multicast route exists.

These taps are the *inter-pipeline* hand-off —
e.g. one pipeline's blanked TIMF2 feeding another's fft2-only analysis,
or fan-out of one antenna stream to many independent receivers.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..utils.host import to_numpy

# tap format codes (NET_RXOUT_* analogs, globdef.h:237-253)
TAP_RAW16 = 0
TAP_RAW18 = 1
TAP_RAW24 = 2
TAP_FFT1 = 3
TAP_TIMF2 = 4
TAP_FFT2 = 5
TAP_BASEB = 6
TAP_BASEBRAW = 7

MULTICAST_BASE = "239.255.0.0"          # z_NETWORK.txt group base
DEFAULT_PORT_BASE = 50_100              # + format offset
PAYLOAD_BYTES = 1392                    # globdef.h:1292 (multiple of 48)
_HDR = struct.Struct("<dddiIhh")        # center, time, userx_freq, ptr,
                                        # block_no, userx_no, direction


def group_for(fmt: int) -> tuple[str, int]:
    base = MULTICAST_BASE.rsplit(".", 1)[0]
    return f"{base}.{fmt}", DEFAULT_PORT_BASE + fmt


@dataclass
class TapHeader:
    passband_center: float = 0.0
    time: float = 0.0
    userx_freq: float = 0.0
    ptr: int = 0
    block_no: int = 0
    userx_no: int = 0
    passband_direction: int = 1


class TapSender:
    """Multicast sender for one tap format (do_network_send analog,
    rxin.c:669; pacing left to the caller like buf.c:554-558).

    dest: a unicast (host, port) to send to instead of the format's
    multicast group."""

    def __init__(self, fmt: int, ttl: int = 1, interface: str | None = None,
                 dest: tuple[str, int] | None = None):
        self.fmt = fmt
        self.group, self.port = dest or group_for(fmt)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                             ttl)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                             1)
        if interface:
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                                 socket.inet_aton(interface))
        self.block_no = 0
        self._pending = b""
        self.header = TapHeader()

    def send(self, data: np.ndarray) -> int:
        """Queue array bytes; emits full PAYLOAD_BYTES packets."""
        self._pending += np.ascontiguousarray(to_numpy(data)).tobytes()
        sent = 0
        while len(self._pending) >= PAYLOAD_BYTES:
            chunk = self._pending[:PAYLOAD_BYTES]
            self._pending = self._pending[PAYLOAD_BYTES:]
            self.block_no += 1
            h = self.header
            pkt = _HDR.pack(h.passband_center, time.time(), h.userx_freq,
                            h.ptr, self.block_no & 0xFFFFFFFF, h.userx_no,
                            h.passband_direction) + chunk
            self.sock.sendto(pkt, (self.group, self.port))
            sent += 1
        return sent

    def flush(self):
        if self._pending:
            pad = PAYLOAD_BYTES - len(self._pending)
            self.send(np.frombuffer(b"\0" * pad, np.uint8))

    def close(self):
        self.sock.close()


class TapReceiver:
    """Multicast receiver reassembling a tap stream
    (thread_rx_raw_netinput / thread_rx_fft1_netinput analog,
    network.c:702-810): tolerates packet loss by zero-filling block-
    number gaps.

    bind: a unicast (host, port) to listen on instead of joining the
    format's multicast group; port 0 takes a free one, which ``port``
    then holds."""

    def __init__(self, fmt: int, timeout: float = 2.0,
                 bind: tuple[str, int] | None = None):
        self.fmt = fmt
        self.group, self.port = group_for(fmt)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if bind is None:
            self.sock.bind(("", self.port))
            mreq = struct.pack("4s4s", socket.inet_aton(self.group),
                               socket.inet_aton("0.0.0.0"))
            self.sock.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_ADD_MEMBERSHIP, mreq)
        else:
            self.sock.bind(bind)
            self.group, self.port = self.sock.getsockname()
        self.sock.settimeout(timeout)
        self.last_block = None
        self.lost_packets = 0

    def recv(self) -> tuple[TapHeader, bytes] | None:
        """One packet (header, payload) or None on timeout.  Gaps are
        accounted in ``lost_packets``."""
        try:
            pkt, _addr = self.sock.recvfrom(_HDR.size + PAYLOAD_BYTES)
        except socket.timeout:
            return None
        vals = _HDR.unpack(pkt[: _HDR.size])
        hdr = TapHeader(passband_center=vals[0], time=vals[1],
                        userx_freq=vals[2], ptr=vals[3], block_no=vals[4],
                        userx_no=vals[5], passband_direction=vals[6])
        if self.last_block is not None:
            gap = (hdr.block_no - self.last_block - 1) & 0xFFFFFFFF
            if 0 < gap < 1 << 16:
                self.lost_packets += gap
        self.last_block = hdr.block_no
        return hdr, pkt[_HDR.size:]

    def recv_array(self, n_bytes: int, dtype=np.float32) -> np.ndarray:
        """Blocking read of n_bytes of stream (zero-filled on loss)."""
        out = b""
        while len(out) < n_bytes:
            r = self.recv()
            if r is None:
                break
            out += r[1]
        out = out[:n_bytes].ljust(n_bytes, b"\0")
        return np.frombuffer(out, dtype)

    def close(self):
        self.sock.close()


class ControlServer:
    """Master control plane (thread_lir_server analog, network.c:1133):
    a tiny TCP server answering slave requests — NETMSG codes for
    calibration data, fft1 info, mode, and frequency-control commands
    (globdef.h:255-265)."""

    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 50_099):
        self.handlers = handlers
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        self.sock.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            with conn:
                try:
                    msg = conn.recv(4096).decode()
                    cmd, _, arg = msg.partition(" ")
                    fn = self.handlers.get(cmd)
                    reply = fn(arg) if fn else "ERR unknown"
                    conn.sendall(str(reply).encode())
                except Exception as e:  # pragma: no cover
                    try:
                        conn.sendall(f"ERR {e}".encode())
                    except Exception:
                        pass

    def close(self):
        self._stop = True
        self._t.join(timeout=1.0)
        self.sock.close()


def control_request(cmd: str, arg: str = "", host: str = "127.0.0.1",
                    port: int = 50_099, timeout: float = 2.0) -> str:
    """Slave-side request (the NETMSG round trip)."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(f"{cmd} {arg}".encode())
        return s.recv(1 << 20).decode()
