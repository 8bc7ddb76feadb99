"""Host driver: the block's pageable copy in to the card inside
``MultiReceiver.process_block`` (the port's span ``multi.h2d``), ms a block
over the profiled slice's ``multi.block`` spans.  A slice reading, which
CUPTI inflates (``rxbench/program_spans.py``); None where the port has no
such span."""

from rxbench.program_spans import ms_per

LAYER = "Host driver (pipeline/receiver.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "msamples_per_s"


def read(traced):
    return ms_per("multi.h2d", "multi.block")
