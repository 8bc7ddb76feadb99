"""Failure detection: overrun counters, heartbeat watchdog, real-time
margin.

Reference analogs:

* ``no_of_rx_overrun_errors`` / ``no_of_tx_overrun_errors`` + the
  ``wg_error`` banner (lsetad.c:1088-1096, pa.c:560-566): every
  input/output path that loses data increments a visible counter; the
  operator sees "RX overrun error N" on the wide graph.
* ``thread_status_flag[THREAD_*]`` (thrdef.h:37-70): every worker
  continuously publishes its state, so a stalled thread is visible to
  the screen thread and to ``lir_errcod`` teardown.  Here each
  component publishes a heartbeat; :class:`Watchdog` flags any that
  stop beating for longer than the timeout.
* the timing display (z_TIMING.txt:6-15, buf.c:1555 ``overrun_count``):
  processed-stream time vs wall time is the margin before an overrun;
  :class:`RealTimeMonitor` reports it continuously.

The reference's detection lives inside soundcard callbacks and a
screen-thread poll loop; here it is three small host-side objects that
the (functional) pipeline threads its progress through — the
step itself stays pure.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..errors import LirError


@dataclass
class OverrunCounter:
    """The no_of_rx/tx_overrun_errors surface (lsetad.c:1093)."""

    name: str = "RX"
    events: int = 0
    units_lost: int = 0     # samples/bytes/packets, caller's unit
    last_message: str = ""

    def record(self, units: int = 1) -> str:
        self.events += 1
        self.units_lost += int(units)
        # the wg_error banner text format (lsetad.c:1094)
        self.last_message = f"{self.name} overrun error {self.events}"
        return self.last_message

    def raise_if_over(self, max_events: int) -> None:
        if self.events > max_events:
            raise LirError(9006, f"{self.name}: {self.events} overruns, "
                                 f"{self.units_lost} units lost")


class Watchdog:
    """Heartbeat monitor for pipeline components (the
    thread_status_flag surface, thrdef.h).

    Components call :meth:`beat` whenever they make progress;
    :meth:`stalled` lists every registered component whose last beat is
    older than the timeout; :meth:`check` raises LirError 9005 for
    them.  :meth:`start` runs the check periodically on a daemon thread
    and reports stalls through a callback instead (the screen-thread
    poll loop analog) — never raising across threads.
    """

    def __init__(self, timeout_s: float = 2.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._beats: dict[str, float] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def beat(self, name: str) -> None:
        with self._lock:
            self._beats[name] = self._clock()

    def remove(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def stalled(self) -> list[str]:
        now = self._clock()
        with self._lock:
            return [n for n, t in self._beats.items()
                    if now - t > self.timeout_s]

    def check(self) -> None:
        bad = self.stalled()
        if bad:
            raise LirError(9005, ", ".join(sorted(bad)))

    def start(self, on_stall, interval_s: float | None = None) -> None:
        """Poll on a daemon thread; call ``on_stall(names)`` when any
        component stalls (once per transition into the stalled state)."""
        if self._thread is not None:
            return
        self._stop.clear()
        period = interval_s if interval_s is not None \
            else max(self.timeout_s / 4, 0.01)

        def run():
            reported: set[str] = set()
            while not self._stop.wait(period):
                bad = set(self.stalled())
                new = bad - reported
                if new:
                    on_stall(sorted(new))
                reported = bad

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="lrt-watchdog")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None


@dataclass
class RealTimeMonitor:
    """Stream-time vs wall-time margin (the timing display,
    z_TIMING.txt:6-15).

    ``advance(n)`` accounts n processed RAW input samples, so
    ``rate_hz`` is the input A/D rate (geo.rx_ad_speed) in both IQ and
    real-input modes; ``margin_s`` is
    how far ahead of real time the pipeline is (negative = falling
    behind, the condition that ends in an overrun once the input
    buffering — ``headroom_s`` — is exhausted)."""

    rate_hz: float
    headroom_s: float = 0.25      # buffered input depth
    clock: object = time.monotonic
    samples: int = 0
    _t0: float | None = field(default=None, repr=False)

    def advance(self, n_samples: int) -> None:
        if self._t0 is None:
            self._t0 = self.clock()
        self.samples += int(n_samples)

    @property
    def stream_s(self) -> float:
        return self.samples / self.rate_hz

    @property
    def margin_s(self) -> float:
        if self._t0 is None:
            return self.headroom_s
        wall = self.clock() - self._t0
        return self.stream_s - wall + self.headroom_s

    def behind(self) -> bool:
        return self.margin_s < 0.0

    def check(self) -> None:
        m = self.margin_s
        if m < 0.0:
            raise LirError(9007, f"{-m:.3f} s behind real time")
