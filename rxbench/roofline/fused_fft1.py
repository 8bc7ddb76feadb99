"""The fused first FFT (``csrc/fused_fft1.cu``) at (B, N, C): B frames of
N points, C channels (a fleet's streams folded into C)."""


def bytes_moved(b: int, n: int, c: int) -> int:
    """Every input read once (frames, window, filtercorr) and every output
    written once (spec, power_sum)."""
    return 8 * b * n * c + 4 * n + 8 * n * c + 8 * b * n * c + 4 * n * c


def operations(b: int, n: int, c: int) -> int:
    """5 n log2 n per transform, and per point 2 for the window, 6 for
    the calibration, 4 for the power."""
    return b * c * (5 * n * (n.bit_length() - 1) + 12 * n)
