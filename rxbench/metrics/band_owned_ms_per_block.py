"""Graphed step: every sub-receiver's outputs copied out of the graph's
memory pool inside ``MultiReceiver.process_block`` (the port's span
``multi.owned``), ms a block over the profiled slice's ``multi.block``
spans.  A slice reading, which CUPTI inflates
(``rxbench/program_spans.py``); None where the port has no such span."""

from rxbench.program_spans import ms_per

LAYER = "Graphed step (pipeline/batch.py, parallel/fleet.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "msamples_per_s"


def read(traced):
    return ms_per("multi.owned", "multi.block")
