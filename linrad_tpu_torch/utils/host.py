"""Host copies of a caller's arrays.

The port's host-side modules (the Morse decoder, signal analysis, the
test modes, the transmit chain, the displays and the network taps) are
numpy, as in the JAX package, where ``np.asarray`` of a device array is
a host copy.  Here their callers hand them the receiver's outputs, which
are torch tensors, on the card as often as not, and ``np.asarray`` of a
CUDA tensor raises.  :func:`to_numpy` takes the place of ``np.asarray``
at those entry points.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x, dtype=None) -> np.ndarray:
    """``np.asarray(x, dtype)`` for a torch tensor on any device (detached
    and copied to the host), a numpy array (returned as ``np.asarray``
    returns it, without a copy where none is needed) or a sequence."""
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(x, dtype)
