"""Multi-process ingest: one recording, every process computing its
shards (port of linrad_tpu/parallel/multihost.py).

The reference's multi-machine form is UDP multicast of stage payloads
(network.c, z_NETWORK.txt); here the processes of a ``torch.distributed``
group each hold some shards of one time-sharded step, and each reads (or
is sent) only its own rows of every step's block.

Usage, the same script in every process, after
``torch.distributed.init_process_group``::

    group = global_time_mesh([f"cuda:{local_rank}"])
    lo, hi = host_rows(group, geo)
    for block in blocks:                      # this process's rows
        rows = scatter_step_block(group, geo, block[lo:hi])
        state, out = sharded_step(tables, state, rows, tune)

In one process the helpers split a whole block over the shards.
"""

from __future__ import annotations

import torch

from ..geometry import Geometry
from .group import DistGroup
from .sharded import shard_group


def global_time_mesh(devices=None, group=None) -> DistGroup:
    """The shard group over every process of the ``torch.distributed``
    group ``group`` (the default group when None): ``devices`` are this
    process's shards (every CUDA device it sees when None), and every
    process has as many."""
    return DistGroup(shard_group(devices).devices, group)


def scatter_step_block(mesh, geo: Geometry, local_block
                       ) -> list[torch.Tensor]:
    """A step block as this process's shards' rows, each on its shard's
    device: the list the sharded step takes.

    local_block: in one process, the whole (samples_per_step, C) block;
    with several, the rows this process's shards own (:func:`host_rows`).
    A process without its rows (None) raises: ship the raw block to the
    other processes first (io.taps, or a shared file system from which
    each reads its rows)."""
    if local_block is None:
        raise ValueError(
            "every process must supply its own rows; ship the raw block "
            "to the other processes first (io.taps or a shared file "
            "system)")
    x = torch.as_tensor(local_block).to(device=mesh.home,
                                        dtype=torch.complex64)
    if x.dim() == 1:
        x = x[:, None]
    if getattr(mesh, "world", 1) == 1:
        return mesh.scatter(x, 0)
    lo, hi = host_rows(mesh, geo)
    if x.shape[0] != hi - lo:
        raise ValueError(f"scatter_step_block: {x.shape[0]} rows, this "
                         f"process owns {hi - lo}")
    return [c.to(d) for c, d in zip(x.chunk(mesh.n_local), mesh.devices)]


def host_rows(mesh, geo: Geometry) -> tuple[int, int]:
    """The [start, stop) sample rows of a step block that this process's
    shards own: what a per-process reader loads for the current step."""
    per = geo.samples_per_step // mesh.axis_size
    first = mesh.axis_index(0)
    return first * per, (first + mesh.n_local) * per
