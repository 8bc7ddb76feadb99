"""The readings a cell's limits are set from, on the card, in one process:

    python3 rxbench/readings.py --workload <cell> --seconds 2 \
        --seeds <n> <n> ... [--control | --torch-fft1] [--detail]

runs the cell once per seed (each run a fresh port, ring and reference,
the same window and check as the benchmark's own runs, at a shorter
``--seconds``) and prints each run's compared numbers, then the largest
reading of each over the seeds.  ``--control`` runs the port with its
bfloat16 fft1 (``fft1_variant="mxu_bf16"``): the lower precision whose
readings set each limit's upper end.  ``--torch-fft1`` runs the port with
``torch.fft`` for fft1 (``fft1_variant="xla"``, the reference's fft1):
the witness that a blanker's flip comes from the two fft1s' rounding.
``--detail`` prints every compared stream-step.  The benchmark's own runs
never run these.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CONTROL = {"fft1_variant": "mxu_bf16"}
TORCH_FFT1 = {"fft1_variant": "xla"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    way = ap.add_mutually_exclusive_group()
    way.add_argument("--control", action="store_true")
    way.add_argument("--torch-fft1", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="print every compared stream-step")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from rxbench import core
    program = (CONTROL if args.control else
               TORCH_FFT1 if args.torch_fft1 else {})
    worst = {}
    for seed in args.seeds:
        result, _lines, _err = core.run_cell(
            args.workload, seed, args.seconds, False, "cuda",
            time.perf_counter(), program=program, keep_records=True)
        nums = {k: c["value"] for k, c in result["checks"].items()}
        print(json.dumps({"seed": seed, "program": program,
                          "correct": result["correct"], "numbers": nums}),
              flush=True)
        if args.detail:
            for kind, step, info in result["records"]:
                print(json.dumps({"kind": kind, **info, **{
                    k: float(f"{v:.4g}") for k, v in step.items()}}))
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program": program,
                      "seeds": len(args.seeds), "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
