"""Segmented reductions along the frequency axis (port of
linrad_tpu/utils/segments.py).

A segment is a contiguous True-run of a boolean mask.  Each member gets
the reduction over its whole segment; non-members get ``fill``.  Segment
ids come from a cumulative sum of the segment starts, the reduction is
one ``scatter_reduce`` into a buffer with a slot per possible segment,
and a gather brings it back to the members — no sequential walk and no
host sync.
"""

from __future__ import annotations

import torch


def segment_starts(mask: torch.Tensor) -> torch.Tensor:
    """True at the first bin of each contiguous True-run of ``mask``."""
    prev = torch.cat([mask.new_zeros(1), mask[:-1]])
    return mask & ~prev


def segment_reduce(values: torch.Tensor, mask: torch.Tensor, reduce: str,
                   fill: float) -> torch.Tensor:
    """Broadcast the full-segment ``reduce`` ("amax", "amin" or "sum") of
    ``values`` to every member of its segment; ``fill`` outside."""
    n = values.shape[0]
    values = values.to(torch.float32)
    ids = torch.cumsum(segment_starts(mask).to(torch.int64), 0) - 1
    ids = torch.where(mask, ids, n)           # slot n collects non-members
    buf = values.new_full((n + 1,), fill)
    buf = buf.scatter_reduce(0, ids, values, reduce=reduce,
                             include_self=False)
    return torch.where(mask, buf[ids], fill)


def segment_max(values, mask):
    return segment_reduce(values, mask, "amax", -float("inf"))


def segment_min(values, mask):
    return segment_reduce(values, mask, "amin", float("inf"))


def segment_sum(values, mask):
    """Per-segment sum broadcast to members (used for region widths)."""
    return segment_reduce(values, mask, "sum", 0.0)
