"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell's
configuration, traffic, limits and family are found by the names
``BENCHMARK.json`` gives (``harness.py``). It needs as many CUDA cards
as the cell asks for, and exits non-zero without a result when they are
not there, or when the process holds JAX or the JAX package once the
window has closed. Set-up, the window and the check are
``harness.run_cell``'s; the last lines of standard error are the
compared numbers beside their limits, the last line of standard output
the result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.load_cell(json.load(f), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print("%s needs %d CUDA card(s); this host has %s" % (
            cell.name, cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "benchmark_out", cell.name)
    result = harness.run_cell(cell, args.seed, args.seconds, args.trace,
                              t_start=T_START, out_dir=out_dir)
    found = harness.forbidden_modules()
    if found:
        print("the measured process holds %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
