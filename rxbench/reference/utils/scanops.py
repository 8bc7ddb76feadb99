"""The sample-rate recurrences of the AGC (port of
linrad_tpu/utils/scanops.py).

torch has no associative scan, so each recurrence gets a form built from
torch primitives:

- ``one_pole``  y[t] = a*y[t-1] + b*x[t]: a blocked scan.  Inside a block
  of ``BLOCK`` samples it is one product with the lower-triangular matrix
  a^(i-j); the block ends then form the same recurrence with coefficient
  a^BLOCK, solved the same way, and each block adds its carry times
  a^(i+1).  Powers stay in [a^BLOCK, 1], so nothing overflows (a closed
  form with a^-t would overflow float32 over a few thousand samples at
  short attack times).
- ``decay_max`` y[t] = max(d*y[t-1], x[t]): a max-plus doubling scan in
  the log domain (log2 n passes of shifted maxima).
- ``sliding_max``: shifted maxima (sparse-table doubling).

All carry a state between blocks, so streamed results match one long
scan.  Matrix products here must run in full float32 (no TF32).
"""

from __future__ import annotations

import torch

BLOCK = 64


def _triangular(a: float, k: int, dtype, device) -> torch.Tensor:
    """L[i, j] = a^(i-j) for j <= i, else 0 (built in float64 on the
    device: no host-to-device copy inside a step)."""
    i = torch.arange(k, dtype=torch.float64, device=device)
    e = i[:, None] - i[None, :]
    low = torch.where(e >= 0, a ** e.clamp(min=0), 0.0)
    return low.to(dtype)


def _affine_scan(v: torch.Tensor, a: float) -> torch.Tensor:
    """y[t] = a*y[t-1] + v[t] along axis 0 with y[-1] = 0; v is (n, K)."""
    n, width = v.shape
    if n <= BLOCK:
        return _triangular(a, n, v.dtype, v.device) @ v
    nb = -(-n // BLOCK)
    vp = torch.cat([v, v.new_zeros((nb * BLOCK - n, width))])
    blocks = vp.reshape(nb, BLOCK, width)
    local = _triangular(a, BLOCK, v.dtype, v.device) @ blocks
    # ends[k] = y at the end of block k
    ends = _affine_scan(local[:, -1], a ** BLOCK)
    prev = torch.cat([ends.new_zeros((1, width)), ends[:-1]])
    grow = (a ** torch.arange(1, BLOCK + 1, dtype=torch.float64,
                              device=v.device)).to(v.dtype)
    y = local + grow[None, :, None] * prev[:, None, :]
    return y.reshape(nb * BLOCK, width)[:n]


def one_pole(x: torch.Tensor, a: float, y0: torch.Tensor, *, dim: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[t] = a*y[t-1] + (1-a)*x[t] along axis ``dim`` with initial state
    y0 (unity DC gain).

    x: float32 with n samples along ``dim``; a a Python float; y0 the
    carried state (x's shape without ``dim``).  Returns (y, y_last).
    ``dim`` is keyword-only: the JAX version's fourth parameter is an
    explicit b, which no caller passes and the port does not take."""
    a = float(torch.tensor(a, dtype=torch.float32))  # a rounded to float32
    b = 1.0 - a
    x = x.movedim(dim, 0)
    shape = x.shape
    bx = (b * x).reshape(shape[0], -1)
    bx = torch.cat([bx[:1] + a * y0.reshape(1, -1), bx[1:]])
    y = _affine_scan(bx, a).reshape(shape)
    return y.movedim(0, dim), y[-1]


def decay_max(x: torch.Tensor, decay: float, y0: torch.Tensor, dim: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[t] = max(decay*y[t-1], x[t]) along axis ``dim`` — peak tracker
    with exponential release.  x > 0 (envelope magnitudes); y0 has x's
    shape without ``dim``.  Returns (y, y_last).

    Log domain, as a doubling scan: after the pass with shift s, ly[t] is
    the max over the last 2s samples of lx[j] + ld*(t-j).  Each pass adds
    one decay of modest size to the candidate, so the winning term is
    rounded about log2(n) times; the closed form ld*t + cummax(lx - ld*t)
    would round against values of size |ld|*n instead."""
    eps = 1e-30
    lx = torch.log(torch.clamp(x, min=eps)).movedim(dim, 0)
    ld = float(torch.log(torch.tensor(decay, dtype=x.dtype)))
    first = torch.maximum(lx[:1], torch.log(torch.clamp(y0, min=eps)) + ld)
    ly = torch.cat([first, lx[1:]])
    s = 1
    while s < ly.shape[0]:
        ly = torch.cat([ly[:s], torch.maximum(ly[s:], ly[:-s] + ld * s)])
        s *= 2
    y = torch.exp(ly)
    return y.movedim(0, dim), y[-1]


def sliding_max(x: torch.Tensor, window: int, dim: int = 0) -> torch.Tensor:
    """Causal sliding-window maximum along axis ``dim`` (AGC hang,
    mix2.c:1569-1620): out[t] = max(x[t-window+1 .. t]), edge clamped."""
    if window <= 1:
        return x
    x = x.movedim(dim, 0)
    n = x.shape[0]
    xp = torch.cat([x[:1].expand((window - 1,) + tuple(x.shape[1:])), x])
    big_k = (window - 1).bit_length() - 1
    d = xp
    for k in range(big_k):
        s = 1 << k
        d = torch.maximum(d[s:], d[:-s])
    off = window - (1 << big_k)
    y = torch.maximum(d[off:], d[: d.shape[0] - off]) if off else d
    return y[-n:].movedim(0, dim)
