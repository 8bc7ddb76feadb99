"""Sellim's edge taper (``csrc/sellim_taper.cu``) on n bins a stream:
12 bytes a bin (lim and budget read, the new lim written), and the
operations of its closed form on given (lim, budget)."""

import numpy as np

# a powf(., 0.9f) counted as float32 operations: a logarithm, a multiply
# and an exponential in extended precision, about 20
POWF_OPS = 20


def bytes_moved(r: int, n: int) -> int:
    return 12 * r * n


def operations(lim, budget) -> int:
    """A dozen a bin (the nearest nonzero bin on each side, the reach
    test, the pick), and for each source that lights (gain > 0, budget >=
    1) one chain of powf as long as the farther of its two fronts
    reaches: at most 64 bins, at most its budget, and short of the next
    nonzero bin or the band's end."""
    n = lim.shape[-1]
    lims = lim.reshape(-1, n).cpu().numpy()
    budgets = np.broadcast_to(budget.cpu().numpy(), lim.shape).reshape(-1, n)
    ops = 12 * lims.size
    for lw, bw in zip(lims, budgets):
        nz = np.flatnonzero(lw != 0)
        gap_r = np.diff(np.append(nz, n))
        gap_l = np.diff(np.insert(nz, 0, -1))
        src = (lw[nz] > 0) & (bw[nz] >= 1)
        by_budget = np.floor(np.minimum(bw[nz], 64.0))
        chain = np.maximum(np.minimum(by_budget, gap_r - 1),
                           np.minimum(by_budget, gap_l - 1))
        ops += POWF_OPS * int(chain[src].sum())
    return ops
