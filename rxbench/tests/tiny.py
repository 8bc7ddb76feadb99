"""The tiny cut the CPU tests run the cells at: fft1 256, 1,024 samples a
step, up to 8 fits, short rings (the port's own tiny flagship cut)."""

import time

TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
            max_pulses_per_block=8)
CELLS = ("ssb-nb-96k.impulsive", "wcw-eme-48k-xy.drift", "ssb-nb-96k.quiet",
         "ssb-nb-96k.fleet8")
SEED = (1 << 31) + 977


def size(cell: str) -> dict:
    return dict(TINY, _ring={"steps": 16 if "fleet" in cell else 8})


def run_tiny(cell: str, seconds: float | None = None, trace: bool = False,
             program: dict | None = None, seed: int = SEED, bench=None):
    """One run of a cell at the tiny cut; the fleet's window long enough
    for a few of its calls (about a second each on a CPU)."""
    from rxbench import core
    if seconds is None:
        seconds = 2.0 if "fleet" in cell else 0.6
    return core.run_cell(cell, seed, seconds, trace, "cpu",
                         time.perf_counter(), size=size(cell),
                         program=program, bench=bench)
