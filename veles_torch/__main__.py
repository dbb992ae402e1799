"""Command-line entry point of the PyTorch port.

    python -m veles_torch <workflow.py> [root.x.y=v ...] [-d cuda|cpu]
                          [--seed N] [--result-file PATH]

Counterpart of ``python -m veles`` for the samples ported so far: the
workflow module is imported first (its ``root`` defaults land), then the
dot-path overrides are applied, then ``--seed`` re-seeds every named
generator; the module's ``create_workflow()`` is built, initialized on
the device and trained. Each finished epoch prints its summary line; the
last line of standard output is one JSON object with the decision
history. The device is ``cuda`` unless ``-d cpu`` is given; asking for
``cuda`` on a host without a card fails.
"""

import argparse
import importlib.util
import json
import logging
import os
import sys

from veles_torch import prng
from veles_torch.config import root


def build_argparser():
    p = argparse.ArgumentParser(
        prog="python -m veles_torch",
        description="Train a workflow of the PyTorch/CUDA port")
    p.add_argument("workflow", help="path to the workflow python module")
    p.add_argument("overrides", nargs="*", default=[],
                   help="root.x.y=value dot-path overrides")
    p.add_argument("-d", "--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--seed", type=int, default=None,
                   help="master seed for every named generator")
    p.add_argument("--result-file", default=None,
                   help="also write the final JSON here")
    return p


def import_file(path, name=None):
    name = name or os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError("cannot import %s" % path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    """Run the CLI; -> the trained workflow."""
    args = build_argparser().parse_intermixed_args(argv)
    logger = logging.getLogger("veles_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    module = import_file(args.workflow, "veles_torch_workflow_module")
    for override in args.overrides:
        root.apply_override(override)
    if args.seed is not None:
        prng.seed_all(args.seed)
    wf = module.create_workflow()
    wf.initialize(device=args.device)
    wf.run()
    result = {"workflow": wf.name, "device": str(wf.device.device),
              "history": wf.decision.history,
              "best_metric": float(wf.decision.best_metric)}
    if args.result_file:
        with open(args.result_file, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return wf


if __name__ == "__main__":
    main()
