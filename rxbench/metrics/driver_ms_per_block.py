"""Host driver: ``Receiver.process_block`` outside the control (the block's
copy to the card, the replay's enqueue, the copies out of the graph's
pool, the audio's fetch): a block's wall time less the device wait and the
control's span, averaged over the traced run's window."""

LAYER = "Host driver (pipeline/receiver.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "block_latency_p95_ms"


def read(traced):
    if "driver" not in traced.host:
        return None
    return 1e3 * traced.host["driver"]
