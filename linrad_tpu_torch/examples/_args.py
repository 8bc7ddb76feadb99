"""The command line the example twins share."""

from __future__ import annotations

import argparse


def parse(doc: str, *positional: tuple) -> argparse.Namespace:
    """``positional``: (name, type, default) of each optional positional
    argument, then ``--device`` (default "cuda") and ``--tiny``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    for name, typ, default in positional:
        ap.add_argument(name, nargs="?", type=typ, default=default)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="a cut geometry and a short signal (tests)")
    return ap.parse_args()


TINY = dict(fft1_n_override=8, target_fft1_frames_per_step=8, fft3_n=6,
            max_pulses_per_block=8)
"""The cut geometry: fft1 256, 1,024 samples per step (as
``flagship_params(tiny=True)``)."""
