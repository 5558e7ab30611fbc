#!/usr/bin/env python3
"""The control of a cell on the card, at the cell's own size: for each
seed, one run (set-up and a short window) judged twice, by the reference
and by the reference with its uint16 vote counters narrowed to uint8 in
the program's place.  The control must come out not correct.  Prints one
JSON line a seed.  Not part of the benchmark's own runs.

    python3 port_bench/control.py --workload <cell> --seconds 1 \
        --seeds 1 2 3
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]

from port_bench import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _, _, config, workload = harness.cell_files(ROOT, args.workload)
    limits = workload["limits"]
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="port_bench-control-")
        try:
            sound, control = harness.control_checks(
                config, workload, seed, args.seconds, "cuda", workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "sound": sound,
            "control": control,
            "control_correct": all(control[k] <= limits[k]
                                   for k in limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
