"""Device: the summed time of the device's operations per block of the
radar path in the profiled slice."""

LAYER = "Device (H100)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    if not traced.ops or not traced.stream_steps:
        return None
    return 1e3 * sum(s for _n, s in traced.ops) / traced.stream_steps
