"""The readings that set a cell's limits: for each seed, a run of the cell
as the benchmark makes it (set-up, a window of `--seconds`, the check),
then the control, the plain reference in bfloat16 put in the program's
place, judged against the float32 reference by the same numbers. The
benchmark's own runs never run the control.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

Needs a CUDA card. Prints one JSON line a seed: {"seed", "program":
{number: value}, "control": {number: value}, "frames"}.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    import argparse

    import torch

    from harness import cell as cells
    from harness import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = cells.run_cell(cell, seed, args.seconds, False, "cuda",
                             time.perf_counter(), control=True)
        print(json.dumps({
            "seed": seed, "frames": out["attempted"],
            "program": {k: v["value"] for k, v in out["check"].items()},
            "control": out["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
