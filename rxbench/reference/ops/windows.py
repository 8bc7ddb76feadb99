"""Window functions and overlap-add synthesis weights (the port's own
copy of linrad_tpu/ops/windows.py; tests/test_torch_config.py holds the
two bit-equal).

Reproduces ``make_window`` (reference fft0.c:812-911) semantics on host
numpy (tables are built once at setup, exactly like Linrad builds them in
``get_buffers`` buf.c:868) and the mixer crossover construction of
``prepare_mixer`` (reference buf.c:55-111).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erfc  # scipy ships with the baked-in stack


def make_window(size: int, sinpow: int, normalize: bool = False) -> np.ndarray:
    """Full-length analysis window.

    sinpow 1..7: sin^N(pi*i/size) (fft0.c:860-868); 8: Gaussian starting at
    -208 dB (fft0.c:847-859); 9: erfc starting at -192 dB (fft0.c:831-845);
    0: rectangular.  ``normalize`` applies Linrad's RMS normalisation
    z = 1/sqrt(2*sumsq/size) (fft0.c:881-885).
    """
    if sinpow == 0:
        return np.ones(size, np.float64)
    half = size // 2
    w = np.zeros(half + 1, np.float64)
    if sinpow == 9:
        e2 = 40.0 / size
        if size < 128:
            e2 /= 1.5
        if size < 64:
            e2 /= 1.7
        e = 4.4 - e2 * np.arange(half + 1)
        w = 0.5 * erfc(e)
    elif sinpow == 8:
        e2 = 9.8 / size
        e = e2 * (half - np.arange(half + 1))
        w = np.exp(-(e ** 2))
    else:
        x = np.pi * np.arange(half + 1) / size
        w = np.sin(x) ** sinpow
    if normalize:
        sumsq = float(np.sum(w[: half + 1] ** 2))
        w = w / math.sqrt(2.0 * sumsq / size)
    full = np.empty(size, np.float64)
    full[: half + 1] = w
    full[half + 1:] = w[1:half][::-1]
    return full


def crossover_points(size: int, interleave_points: int, new_points: int,
                     sinpow: int, window: np.ndarray) -> int:
    """Length of the sin^2/cos^2 crossover region for overlap-add synthesis.

    Reference ``prepare_mixer`` buf.c:66-93: stop the crossover where the
    window has fallen a factor 30 in amplitude relative to the value at
    interleave/2; special windows use fixed fractions.  NB the
    reference's ``m[0].window`` is the INVERSE window (make_window mode
    3, buf.c:61), so its ``window[i] < 30*t1`` walk reads, in
    forward-window terms, ``w[i] > w[i0]/30`` (verified by matching
    ``mix1.crossover_points`` of the compiled reference at sinpow 1/3/4).
    """
    if sinpow in (0, 2):
        # no window -> plain concatenation; sin^2 -> 50% overlap-add
        return 0
    if sinpow == 9:
        return size // 8
    if sinpow == 8:
        return size // 16
    i = interleave_points // 2
    t1 = window[i]
    cp = 0
    while i > 0 and window[i] > t1 / 30.0:
        i -= 1
        cp += 1
    cp = min(cp, int(0.75 * new_points), interleave_points // 2)
    return cp


def synthesis_weights(size: int, interleave_points: int, sinpow: int
                      ) -> np.ndarray:
    """Per-sample overlap-add synthesis weights for reconstructing the
    *unwindowed* signal from windowed overlapped inverse transforms.

    Encodes the three cases of ``do_mix1`` (reference mix1.c:141-280) as a
    single weight vector ``s`` such that
    ``out[t] = sum_b  y_b[t - b*hop] * s[t - b*hop]``
    where ``y_b`` is the inverse transform of a frame analysed with window
    ``w``:

    - sinpow 0: no window, s = 1 on the central ``new`` points.
    - sinpow 2 at 50% overlap: s = 1 everywhere (sin^2+cos^2 == 1,
      mix1.c:158-200).
    - otherwise: s = 1/w on the exclusive centre (inverse window,
      make_window mode 3, fft0.c:872-880) with sin^2/cos^2 ramps divided by
      w over the crossover region (buf.c:97-109).

    Exactness for any tone is checked by tests against direct mixing.
    """
    w = make_window(size, sinpow)
    new = size - interleave_points
    s = np.zeros(size, np.float64)
    half_ov = interleave_points // 2
    if sinpow == 0:
        s[:] = 1.0
        return s
    if sinpow == 2 and interleave_points == size // 2:
        return np.ones(size, np.float64)
    cp = crossover_points(size, interleave_points, new, sinpow, w)
    lo = half_ov  # start of the "new" region within the frame
    hi = half_ov + new
    with np.errstate(divide="ignore"):
        inv = np.where(w > 0, 1.0 / np.maximum(w, 1e-30), 0.0)
    # exclusive centre
    s[lo + cp // 2 + (cp & 1): hi - cp // 2] = \
        inv[lo + cp // 2 + (cp & 1): hi - cp // 2]
    if cp > 0:
        t = (np.arange(cp) + 0.5) * 0.5 * np.pi / cp
        rise = np.sin(t) ** 2
        fall = np.cos(t) ** 2
        a = lo - cp // 2
        s[a: a + cp] = rise * inv[a: a + cp]
        b = hi - cp // 2
        s[b: b + cp] = fall * inv[b: b + cp]
    return s
