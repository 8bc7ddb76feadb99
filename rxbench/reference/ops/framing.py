"""Overlap framing and overlap-add (port of linrad_tpu/ops/framing.py).

Each pipeline step consumes a fixed block of samples plus a carried tail,
produces a fixed batch of overlapped frames, and carries the new tail
forward in the pipeline state — the static-shape form of Linrad's
circular buffers (reference z_BUFFERS.txt:1-50).
"""

from __future__ import annotations

import torch


def frame_stream(tail: torch.Tensor, block: torch.Tensor, frame_size: int,
                 hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``concat(tail, block)`` into overlapped frames.

    The sample axis is the last but one, so any number of leading batch
    axes (the sub-receiver axis of the multi-receiver step) ride along.

    tail:  (..., frame_size - hop, C) carried samples from the previous step
    block: (..., S, C) new samples with S % hop == 0

    Returns (frames, new_tail): frames (..., S//hop, frame_size, C)
    contiguous, frame b covering samples [b*hop, b*hop + frame_size) of the
    concatenated stream; new_tail the last (frame_size - hop) samples.
    """
    overlap = frame_size - hop
    if tail.shape[-2] != overlap or block.shape[-2] % hop:
        raise ValueError(f"frame_stream: tail {tuple(tail.shape)} / block "
                         f"{tuple(block.shape)} do not fit frame "
                         f"{frame_size} hop {hop}")
    s = block.shape[-2]
    buf = torch.cat([tail, block], dim=-2)
    # unfold puts the window axis last: (..., n, C, frame_size)
    frames = buf.unfold(-2, frame_size, hop).movedim(-1, -2).contiguous()
    return frames, buf[..., s:, :]


def make_tail(frame_size: int, hop: int, trailing_shape=(),
              dtype=torch.complex64, *, device) -> torch.Tensor:
    """Zero-initialised carry tail for :func:`frame_stream`:
    (frame_size - hop,) + trailing_shape, on ``device``."""
    return torch.zeros((frame_size - hop,) + tuple(trailing_shape),
                       dtype=dtype, device=device)


def overlap_add(frames: torch.Tensor, hop: int, carry: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap-add a batch of frames at the given hop.

    frames: (..., n, frame_size, C); carry: (..., frame_size - hop, C)
    partial sums from the previous step.  Returns (out (..., n*hop, C),
    new_carry), summing in the same order as the JAX version (chunk j of
    every frame in turn, then the carry)."""
    lead = tuple(frames.shape[:-3])
    n, size, c = frames.shape[-3:]
    overlap = size - hop
    if carry.shape[-2] != overlap:
        raise ValueError(f"overlap_add: carry {tuple(carry.shape)} for frame "
                         f"{size} hop {hop}")
    k = -(-size // hop)  # chunks per frame
    pad = k * hop - size
    if pad:
        frames = torch.cat([frames, frames.new_zeros(lead + (n, pad, c))],
                           dim=-2)
    chunks = frames.reshape(lead + (n, k, hop, c))
    total = frames.new_zeros(lead + (n + k - 1, hop, c))
    for j in range(k):
        total[..., j: j + n, :, :] += chunks[..., j, :, :]
    flat = total.reshape(lead + (-1, c))
    flat[..., :overlap, :] += carry
    return (flat[..., : n * hop, :],
            flat[..., n * hop: n * hop + overlap, :])
