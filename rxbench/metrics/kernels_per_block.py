"""Graphed step: the device's operations (kernels, copies, fills) per
stream-step in the profiled slice."""

LAYER = "Graphed step (pipeline/batch.py, parallel/fleet.py)"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    if not traced.ops or not traced.stream_steps:
        return None
    return len(traced.ops) / traced.stream_steps
