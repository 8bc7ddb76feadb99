"""Host control: the spur scan's copies between host and card (the port's
spans ``spur.read``, the spectrum, the tuned bin and the four spur state
tensors to the host, and ``spur.write``, the four back), ms a block over
the profiled slice's ``rx.block`` spans.  A slice reading, which CUPTI
inflates (``rxbench/program_spans.py``); None where the port has no such
spans."""

from rxbench.program_spans import ms_per

LAYER = "Host control (pipeline/control.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "msamples_per_s"


def read(traced):
    read_ms = ms_per("spur.read", "rx.block")
    write_ms = ms_per("spur.write", "rx.block")
    if read_ms is None or write_ms is None:
        return None
    return read_ms + write_ms
