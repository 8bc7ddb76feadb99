"""The yardstick of the kernels' roofline shares: the published peaks of
one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its full power limit
of 700 W; the run prints the card's own limit beside every result) and,
one file a kernel, the bytes and operations a call must move and compute,
frozen copies of the arithmetic the port's smoke test uses
(``chip_smoke.py``: phase 3's ``necessary_bytes``/``operations``, phase
3b's ``fits_bytes_ops`` and ``taper_ops``)."""

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at the memory's peak or
    operations at float32's, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S)
