"""A/D sample frames (one complex sample per channel, counted once per
instant), summed over streams, of every block whose audio reached the
host inside the window, over the window's seconds: millions a second."""


def read(window: dict):
    return window["frames"] / window["window_s"] / 1e6
