"""Process start to the first timed block: imports, the kernels' build
(on a checkout's first run), the ring, the port's set-up and capture, the
warm-up."""


def read(window: dict):
    return window["setup_s"]
