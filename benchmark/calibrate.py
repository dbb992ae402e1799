"""The readings that the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload <name> --seed <n> \
        --seconds <s>

One run of the cell as ``run.py`` makes it, at its own size and window,
that also puts the control (the reference computed with fp8 products)
and a planted fault (the reference taking the mean over the first half
of each minibatch) in the program's place, in both checks, against the
float32 reference. A step that leaves the state unchanged reads 1 on the
leaf numbers by construction and is not run. Prints one JSON line: the
seed, the program's numbers (the lower readings), the control's and the
fault's (the upper ones), ``correct`` under the limits in force, and the
window's metrics. Run it once a seed, each in a process of its own.
"""

import argparse
import json
import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.load_cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    result = harness.run_cell(
        cell, args.seed, args.seconds, 0, t_start=T_START,
        out_dir=os.path.join(ROOT, "benchmark_out", cell.name),
        controls=True)
    row = {"seed": args.seed,
           "program": {k: v["value"] for k, v in result["check"].items()}}
    row.update(result["calibration"])
    row.update({k: result[k] for k in ("correct", "attempted", "metrics")})
    row["memory_peak_bytes"] = result["device"]["memory_peak_bytes"]
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
