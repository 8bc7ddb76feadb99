"""Least-squares and peak-fitting utilities (the port's own copy of
linrad_tpu/utils/llsq.py; tests/test_torch_config.py holds the two
bit-equal).

Equivalent of the reference's LLSQ library (llsq.c:29-402): Gaussian-
elimination linear least squares (``llsq1``/``llsq2``), 3-point
parabolic peak interpolation (``parabolic_fit`` llsq.c:113) and tophat
mask filters (``mask_tophat_filter1/2`` llsq.c:29/73).  Host-rate code —
numpy is fine; the solvers are tiny (<=25 parameters in the reference).
"""

from __future__ import annotations

import numpy as np


def llsq_fit(basis: np.ndarray, y: np.ndarray,
             weights: np.ndarray | None = None) -> np.ndarray:
    """Solve min ||diag(w) (A c - y)|| for c.  basis: (n, k)."""
    a = np.asarray(basis, np.float64)
    yy = np.asarray(y, np.float64)
    if weights is not None:
        w = np.sqrt(np.asarray(weights, np.float64))
        a = a * w[:, None]
        yy = yy * w
    c, *_ = np.linalg.lstsq(a, yy, rcond=None)
    return c


def polyfit_drift(t: np.ndarray, f: np.ndarray, degree: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Polynomial fit of frequency vs time (the AFC fit, llsq usage in
    afc_eval_line).  Returns coefficients lowest-order first."""
    t = np.asarray(t, np.float64)
    basis = np.stack([t ** k for k in range(degree + 1)], axis=1)
    return llsq_fit(basis, f, weights)


def parabolic_peak(ym1: float, y0: float, yp1: float) -> tuple[float, float]:
    """3-point parabolic fit around a sampled maximum (llsq.c:113):
    returns (offset in [-0.5, 0.5], interpolated peak value)."""
    denom = ym1 + yp1 - 2.0 * y0
    if abs(denom) < 1e-30:
        return 0.0, y0
    off = 0.5 * (ym1 - yp1) / denom
    off = float(np.clip(off, -0.5, 0.5))
    peak = y0 - 0.25 * (ym1 - yp1) * off
    return off, peak


def mask_tophat_filter(mask_width: int, x: np.ndarray) -> np.ndarray:
    """Zero-phase tophat (boxcar) smoothing, edges clamped
    (mask_tophat_filter1, llsq.c:29)."""
    if mask_width <= 1:
        return np.asarray(x, np.float64)
    k = np.ones(mask_width) / mask_width
    pad = mask_width // 2
    xp = np.pad(np.asarray(x, np.float64), pad, mode="edge")
    out = np.convolve(xp, k, mode="same")[pad: pad + len(x)]
    return out
