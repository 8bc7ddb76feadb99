"""Scale-out (port of linrad_tpu/parallel/): one stream split along time
over several shards (``ShardedReceiver``, ``ShardedMultiReceiver``,
``ShardedBatchRunner``, on the collectives of :mod:`.group`), processes
that each hold some of the shards (:mod:`.multihost`), and many
independent receivers as one batched step on one or several devices
(``FleetRunner``)."""

from .fleet import FleetRunner
from .group import DistGroup, LocalGroup
from .multihost import global_time_mesh, host_rows, scatter_step_block
from .sharded import (ShardedBatchRunner, ShardedMultiReceiver,
                      ShardedReceiver, make_sharded_multi_rx_step,
                      make_sharded_rx_step)

__all__ = ["ShardedReceiver", "ShardedMultiReceiver",
           "ShardedBatchRunner", "FleetRunner",
           "make_sharded_rx_step", "make_sharded_multi_rx_step",
           "global_time_mesh", "scatter_step_block", "host_rows",
           "LocalGroup", "DistGroup"]
