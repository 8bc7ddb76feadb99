"""Shard groups: the collectives of the time-sharded step (the port's
counterpart of ``jax.sharding.Mesh``, ``shard_map`` and ``lax.ppermute``/
``psum``/``pmean``/``all_gather``/``axis_index``).

One Python thread runs a process's local shards in lockstep.  A value
that the JAX step holds per shard is a list here, one tensor per local
shard, each on that shard's device; a replicated value is one tensor on
the group's ``home`` device (its first local device), computed once per
process.  The collectives are functions of such lists, named after
JAX's:

- ``from_left(xs)`` / ``from_right(xs)``: each shard's neighbour's value,
  zeros on the first (last) shard, as ``ppermute`` gives them;
- ``pick_last(xs)``: the last shard's value, replicated;
- ``psum(xs)`` / ``pmean(xs)``: the sum (mean) over every shard, summed in
  shard order, so that a result never depends on timing;
- ``all_gather(xs, dim)``: every shard's value concatenated along ``dim``
  in shard order (JAX's ``tiled=True``), replicated;
- ``axis_index(i)``: local shard i's place among all shards, and
  ``axis_size``: their number.

:class:`LocalGroup` holds every shard in one process: ``["cpu"] * 4``,
``["cuda:0"] * 4`` (four shards on one card) or one shard per card; a
neighbour exchange is a ``.to(device)`` copy, with no staging through the
host.  :class:`DistGroup` spreads the shards over the processes of a
``torch.distributed`` group, any number of them per process, in
process-major order as JAX's multi-process mesh orders them: within a
process it works as :class:`LocalGroup` does; across processes the
neighbour exchanges are ``batch_isend_irecv`` and the rest ``all_gather``.
Both give the same bits for the same shards.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist


def _map(fn, tree):
    """fn applied to every tensor of a tree of dataclasses (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(**{f.name: _map(fn, getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


@functools.lru_cache(maxsize=16)
def _divisor(n: int, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """n as a 0-dim tensor on the device, made once: a copy from the host
    inside a step would wait for the host and could not be captured into
    a CUDA graph."""
    return torch.tensor(n, dtype=dtype, device=device)


def _ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


class LocalGroup:
    """Every shard in this process, on ``devices`` (one entry per shard;
    a device may repeat)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        self.home = self.devices[0]
        self.offset = 0

    @property
    def axis_size(self) -> int:
        return len(self.devices)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def axis_index(self, i: int) -> int:
        """Local shard i's index among every shard of the group."""
        return self.offset + i

    # ---- placement ----------------------------------------------------
    def replicate(self, x):
        """A replicated tensor (or tree of dataclasses) as one copy per
        local shard, each on its shard's device."""
        return [_map(lambda t, d=d: t.to(d), x) for d in self.devices]

    def scatter(self, x: torch.Tensor, dim: int = 0) -> list[torch.Tensor]:
        """This process's shards' pieces of a tensor that spans every
        shard along ``dim`` (``axis_size`` equal chunks), each on its
        shard's device."""
        if x.shape[dim] % self.axis_size:
            raise ValueError(f"scatter: {x.shape[dim]} rows do not split "
                             f"into {self.axis_size} shards")
        n = x.shape[dim] // self.axis_size
        return [x.narrow(dim, self.axis_index(i) * n, n).to(d)
                for i, d in enumerate(self.devices)]

    # ---- collectives --------------------------------------------------
    def from_left(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        first = self._from_prev_process(xs[-1], xs[0])
        return [first] + [x.to(d) for x, d in zip(xs[:-1], self.devices[1:])]

    def from_right(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        last = self._from_next_process(xs[0], xs[-1])
        return [x.to(d) for x, d in zip(xs[1:], self.devices[:-1])] + [last]

    def all_gather(self, xs: list[torch.Tensor], dim: int = 0
                   ) -> torch.Tensor:
        return torch.cat(self._gather([x.to(self.home) for x in xs]), dim)

    def psum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return _ordered_sum(self._gather([x.to(self.home) for x in xs]))

    def pmean(self, xs: list[torch.Tensor]) -> torch.Tensor:
        # a 0-dim divisor: a Python one is a multiplication by the
        # reciprocal on a CUDA tensor
        total = self.psum(xs)
        return total / _divisor(self.axis_size, total.dtype, total.device)

    def pick_last(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return self._gather([xs[-1].to(self.home)])[-1]

    # ---- what crosses processes (nothing here) ------------------------
    def _gather(self, local: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every process's ``local`` (tensors of one shape on ``home``),
        in process order."""
        return local

    def _from_prev_process(self, last: torch.Tensor, like: torch.Tensor
                           ) -> torch.Tensor:
        """The previous process's last shard's value (zeros on the
        first process), for this process's first shard."""
        return torch.zeros_like(like)

    def _from_next_process(self, first: torch.Tensor, like: torch.Tensor
                           ) -> torch.Tensor:
        return torch.zeros_like(like)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor as torch.distributed carries it: complex as its real
    pairs, bool as bytes, contiguous."""
    if x.is_complex():
        x = torch.view_as_real(x)
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous()


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(w)
    return w.to(like.dtype)


class DistGroup(LocalGroup):
    """The shards of every process of a ``torch.distributed`` group:
    ``devices`` are this process's shards, and every process has as many.
    Global shard order is process-major (process r holds shards
    r*n .. r*n+n-1).  The caller initialises the process group (gloo on
    the CPU, NCCL on CUDA devices); every collective makes its
    ``torch.distributed`` calls at every world size, one process too."""

    def __init__(self, devices, group=None):
        super().__init__(devices)
        if not dist.is_initialized():
            raise RuntimeError("DistGroup: torch.distributed is not "
                               "initialised (init_process_group first)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        counts = self._gather([torch.tensor([self.n_local],
                                            device=self.home)])
        if any(int(c) != self.n_local for c in counts):
            raise ValueError(f"DistGroup: shards per process differ: "
                             f"{[int(c) for c in counts]}")
        self.offset = self.rank * self.n_local

    @property
    def axis_size(self) -> int:
        return self.world * self.n_local

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r) if self.group else r

    def _gather(self, local: list[torch.Tensor]) -> list[torch.Tensor]:
        like = torch.stack(local)
        wire = _wire(like)
        bufs = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(bufs, wire, group=self.group)
        return [x for b in bufs for x in _unwire(b, like).unbind(0)]

    def _exchange(self, send: torch.Tensor, like: torch.Tensor,
                  to: int, frm: int) -> torch.Tensor:
        """Send ``send`` to process ``to`` and receive a tensor shaped as
        ``like`` from process ``frm`` (either out of range: none posted,
        zeros received), in one batch of point-to-point operations."""
        ops = []
        if 0 <= to < self.world:
            ops.append(dist.P2POp(dist.isend, _wire(send), self._peer(to),
                                  self.group))
        buf = None
        if 0 <= frm < self.world:
            buf = torch.empty_like(_wire(like))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(frm),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.zeros_like(like) if buf is None else _unwire(buf, like)

    def _from_prev_process(self, last, like):
        return self._exchange(last, like, self.rank + 1, self.rank - 1)

    def _from_next_process(self, first, like):
        return self._exchange(first, like, self.rank - 1, self.rank + 1)
