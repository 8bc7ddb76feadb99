"""Kernels: the blanker's fits' share of their roofline: for each call the
larger of its bytes at the memory's peak and its operations at
float32's, counted for the fits the inputs ran (the blocks'
``blanker_fitted``), over the prep and fits kernels' time."""

from rxbench.roofline import blanker_fits as roof
from rxbench.roofline import bound_s

LAYER = "Kernels (ops/ and csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "msamples_per_s"


def read(traced):
    times = traced.op_seconds("blanker_prep_kernel", "blanker_fits_kernel")
    fits = traced.counts.get("fits")
    if not times or not fits:
        return None
    sh = traced.shapes["fits"]
    bound = sum(bound_s(*roof.bytes_ops(sh["r"], sh["total"], sh["c"],
                                        sh["nblk"], sh["pul"], sh["s"], m))
                for m in fits)
    return 100.0 * bound / sum(times)
