"""One run of one cell of the benchmark:

    python3 rxbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints lines about the run, then as the last line of standard output one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error).
Without a CUDA device it exits with 2 and prints no result; if a module
of JAX or of the JAX package is loaded when the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process, few threads: the host's numpy work (the AFC's fits) and
# torch's own CPU pool run on one thread each, so that no pool of spinning
# workers contends with the driving thread on a host shared with others
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a library the port uses must not load JAX on its own
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("rxbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    from rxbench import core
    result, lines, err = core.run_cell(args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       "cuda", T_START)
    bad = core.forbidden_loaded()
    if bad:
        print(f"rxbench: modules {bad} are loaded; the run may load "
              f"nothing of JAX or of the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    print(err, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
