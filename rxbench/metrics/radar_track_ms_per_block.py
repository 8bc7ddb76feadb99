"""Host radar tracker: ``RadarTracker.feed`` inside ``RadarFront.feed``
(the port's span ``radar.track``: the power and statistics read to the
host, the lock's search, the pulses' scan and the display updates, the
history's trim), ms a block over the profiled slice's ``radar.block``
spans.  The front's device work is waited for before it (``radar.wait``).
A slice reading, which CUPTI inflates (``rxbench/program_spans.py``); None
where the port has no such span."""

from rxbench.program_spans import ms_per

LAYER = "Host radar tracker (weak/radar.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "msamples_per_s"


def read(traced):
    return ms_per("radar.track", "radar.block")
