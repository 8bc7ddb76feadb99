"""Kernels: sellim's edge taper's share of its roofline: 12 bytes a bin at
the memory's peak, or its closed form's operations (counted on the plain
reference's own calls on the checked blocks) at float32's, whichever is
longer, over the kernel's mean time."""

from rxbench.roofline import bound_s
from rxbench.roofline import sellim_taper as roof

LAYER = "Kernels (ops/ and csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    times = traced.op_seconds("sellim_taper_kernel")
    if not times:
        return None
    r, n = traced.shapes["taper"]
    ops = r * traced.counts.get("taper_ops", 12 * n)
    bound = bound_s(roof.bytes_moved(r, n), ops)
    return 100.0 * bound * len(times) / sum(times)
