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

    tail:  (frame_size - hop, ...) carried samples from the previous step
    block: (S, ...) new samples with S % hop == 0

    Returns (frames, new_tail): frames (S//hop, frame_size, ...) contiguous,
    frame b covering samples [b*hop, b*hop + frame_size) of the
    concatenated stream; new_tail the last (frame_size - hop) samples.
    """
    overlap = frame_size - hop
    if tail.shape[0] != overlap or block.shape[0] % hop:
        raise ValueError(f"frame_stream: tail {tuple(tail.shape)} / block "
                         f"{tuple(block.shape)} do not fit frame "
                         f"{frame_size} hop {hop}")
    s = block.shape[0]
    buf = torch.cat([tail, block], dim=0)
    # unfold puts the window axis last: (n, ..., frame_size)
    frames = buf.unfold(0, frame_size, hop).movedim(-1, 1).contiguous()
    return frames, buf[s:]


def overlap_add(frames: torch.Tensor, hop: int, carry: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap-add a batch of frames at the given hop.

    frames: (n, frame_size, ...); carry: (frame_size - hop, ...) partial
    sums from the previous step.  Returns (out (n*hop, ...), new_carry),
    summing in the same order as the JAX version (chunk j of every frame
    in turn, then the carry)."""
    n, size = frames.shape[0], frames.shape[1]
    overlap = size - hop
    if carry.shape[0] != overlap:
        raise ValueError(f"overlap_add: carry {tuple(carry.shape)} for frame "
                         f"{size} hop {hop}")
    k = -(-size // hop)  # chunks per frame
    pad = k * hop - size
    trailing = tuple(frames.shape[2:])
    if pad:
        frames = torch.cat([frames, frames.new_zeros((n, pad) + trailing)],
                           dim=1)
    chunks = frames.reshape((n, k, hop) + trailing)
    total = frames.new_zeros((n + k - 1, hop) + trailing)
    for j in range(k):
        total[j: j + n] += chunks[:, j]
    flat = total.reshape((-1,) + trailing)
    flat[:overlap] += carry
    return flat[: n * hop], flat[n * hop: n * hop + overlap]
