"""float32 sums and prefix sums taken in the order XLA's CPU backend
takes them.

A float32 sum depends on the order of its additions.  ``torch.cumsum``
on the CPU accumulates in float64 and ``torch.sum`` in vectorised
partial sums; XLA's CPU backend rewrites both into blocked sequential
sums:

- a prefix sum (``jnp.cumsum``, a reduce-window as long as the axis)
  runs a sequential prefix inside blocks of 16, takes the blocks'
  totals, scans those the same way, and adds each block the exclusive
  prefix of the totals before it;
- a sum (``jnp.sum``) adds blocks of 32 sequentially (a ragged axis
  padded at both ends), then the blocks' sums in blocks of 32, until
  one value is left.

Where a value of the JAX package passes through such a sum and a later
stage amplifies its rounding (mix1's fractional-bin ramp, ahead of
mix2's compensation of the mix1 window at the band edges), the port
takes the sum in the same order with plain float32 additions, which
round alike on the CPU and on the card.
"""

from __future__ import annotations

import torch

PREFIX_BLOCK = 16
SUM_BLOCK = 32


def _blocks(x: torch.Tensor, base: int, centred: bool = False
            ) -> torch.Tensor:
    """The last axis zero-padded to a multiple of ``base`` (at the end, or
    split evenly between both ends, the smaller half first) and split into
    (..., blocks, base)."""
    pad = (-x.shape[-1]) % base
    if pad:
        lo = pad // 2 if centred else 0
        x = torch.cat([x.new_zeros(x.shape[:-1] + (lo,)), x,
                       x.new_zeros(x.shape[:-1] + (pad - lo,))], -1)
    return x.reshape(x.shape[:-1] + (-1, base))


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, one addition after the
    other."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, -1)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in XLA's CPU order
    (``jnp.cumsum(x, axis=-1)`` bit for bit)."""
    n = x.shape[-1]
    if n <= PREFIX_BLOCK:
        return _sequential_prefix(x)
    inner = _sequential_prefix(_blocks(x, PREFIX_BLOCK))
    totals = ordered_cumsum(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]),
                        totals[..., :-1]], -1)
    out = inner + before[..., None]
    return out.reshape(x.shape[:-1] + (-1,))[..., :n]


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum along the last axis in XLA's CPU order (``jnp.sum(x,
    axis=-1)`` bit for bit)."""
    while x.shape[-1] > SUM_BLOCK:
        x = _sequential_sum(_blocks(x, SUM_BLOCK, centred=True))
    return _sequential_sum(x)
