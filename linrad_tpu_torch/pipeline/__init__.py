"""Pipeline assembly (port of linrad_tpu/pipeline/): the per-step signal
chain (chain.py), the host-side AFC and spur control (control.py), the
receivers (receiver.py) and the K-steps-per-call runner (batch.py), with
the same public names as the JAX package's."""

from .batch import BatchRunner
from .chain import RxOutputs, RxState, RxTables, make_rx_step
from .receiver import MultiReceiver, Receiver, Transport

__all__ = ["Receiver", "MultiReceiver", "Transport", "BatchRunner",
           "RxState", "RxTables", "RxOutputs", "make_rx_step"]
