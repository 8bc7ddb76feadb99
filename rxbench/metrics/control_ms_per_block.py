"""Host control: ``WeakSignalControl.update`` (the AFC's read of the
spectrum, its numpy work, the tuning's copies), timed after a
synchronise that takes the device's wait out of it, averaged over the
traced run's window."""

LAYER = "Host control (pipeline/control.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "block_latency_p95_ms"


def read(traced):
    if "control" not in traced.host:
        return None
    return 1e3 * traced.host["control"]
