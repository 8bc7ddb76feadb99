"""Kernels: the fused first FFT's share of its roofline, the least time
its bytes and operations at the shape take at the H100's peaks, over the
kernel's mean time in the slice."""

from rxbench.roofline import bound_s
from rxbench.roofline import fused_fft1 as roof

LAYER = "Kernels (ops/ and csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    times = traced.op_seconds("fused_fft1_kernel")
    if not times:
        return None
    b, n, c = traced.shapes["fft1"]
    bound = bound_s(roof.bytes_moved(b, n, c), roof.operations(b, n, c))
    return 100.0 * bound * len(times) / sum(times)
