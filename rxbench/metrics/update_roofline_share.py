"""Kernels: sellim's liminfo update's share of its roofline: 20 bytes a
bin at the memory's peak a call, over the time of the call's front and
back kernels (``sellim_front_kernel``, ``sellim_back_kernel``; the taper's
kernel between them has a share of its own).  None where the slice holds
neither kernel."""

from rxbench.roofline import bound_s
from rxbench.roofline import sellim_update as roof

LAYER = "Kernels (ops/ and csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    calls = len(traced.op_seconds("sellim_front_kernel"))
    times = traced.op_seconds("sellim_front_kernel", "sellim_back_kernel")
    if not calls or "update" not in traced.shapes:
        return None
    r, n = traced.shapes["update"]
    return 100.0 * calls * bound_s(roof.bytes_moved(r, n), 0) / sum(times)
