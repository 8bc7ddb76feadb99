"""Sellim's liminfo update (``csrc/sellim_update.cu``: a front kernel and a
back kernel a call, around the taper's launch) on n bins a stream: 20
bytes a bin (the averaged power, the old liminfo and its hold counts read,
the new liminfo and hold counts written), as the port's smoke test counts
them (``chip_smoke.py``, phase 3b's ``update_case``)."""


def bytes_moved(r: int, n: int) -> int:
    return 20 * r * n
