"""Host control: the spur manager's search (the port's span
``spur.search``: the numpy drop, re-centre and candidate search, with its
median and full sort of the spectrum), ms a block over the profiled
slice's ``rx.block`` spans.  A slice reading, which CUPTI inflates
(``rxbench/program_spans.py``); None where the port has no such span."""

from rxbench.program_spans import ms_per

LAYER = "Host control (pipeline/control.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "msamples_per_s"


def read(traced):
    return ms_per("spur.search", "rx.block")
