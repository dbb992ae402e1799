#!/usr/bin/env python3
"""What a planted fault moves: the reading behind phase parallel_ep_pp's
movement bar, on the card.

    python3 tools/parallel_faults.py

``chip_smoke.py`` holds its expert- and pipeline-parallel 110M runs
against a one-process run by every tensor's movement (max over tensors of
max|Δ_run − Δ_1| / max|Δ_1|, Δ the weights less the seed's), within
``PARALLEL_DP_RTOL``. This runs each of those configs once more with a
fault planted in both ranks (``tests/torch_parallel_workers.planted``),
2 ranks on one card over gloo-host, through the CLI as the phase does:

* ``ep_gather`` + ``"combine"``: the gather-mode MoE's combine all-reduce
  skipped (each rank keeps its own experts' outputs);
* ``pp_gpipe`` + ``"hop"``: GPipe's backward hop of microbatch 0 of 4
  skipped (the last stage sends nothing, stage 0 takes zeros).

Prints one JSON line per fault (its reading beside the bar and the
worst tensors, the card's name and power limit), also written to
``parallel_faults.jsonl`` in ``chip_smoke.OUT_DIR``; exits 1 if a reading
is not above the bar.
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def faulted_rank(fault, argv):
    """One rank of a CLI run with ``fault`` planted. The workers' module
    is loaded from its file: ``tests`` has no ``__init__.py``, and an
    installed package of that name would shadow it."""
    import importlib.util
    from veles_torch.__main__ import main
    spec = importlib.util.spec_from_file_location(
        "torch_parallel_workers",
        os.path.join(HERE, "tests", "torch_parallel_workers.py"))
    workers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workers)
    with workers.planted(fault):
        main(argv)


def main():
    import numpy
    import torch
    import chip_smoke as C
    from veles_torch import kernels
    from veles_torch.znicz import parallel
    os.makedirs(C.OUT_DIR, exist_ok=True)
    log = os.path.join(C.OUT_DIR, "parallel_faults.jsonl")
    card = C.card_line()
    print(card, flush=True)
    kernels.build()
    tmp = tempfile.mkdtemp(prefix="parallel_faults_")
    bad = []
    try:
        for tag, fault, overrides, axes in (
                ("ep_gather", "combine", C.PARALLEL_MOE
                 + ("root.lm.parallel.ep_routing=gather",), {"expert": 2}),
                ("pp_gpipe", "hop", C.PARALLEL_STACK
                 + ("root.lm.parallel.schedule=gpipe",
                    "root.lm.parallel.microbatches=%d" % C.PARALLEL_MICRO),
                 {"pipe": 2})):
            start = C.initial_archive(tmp, *overrides, tag=tag + "_initial")
            single, _, want = C.parallel_single(torch, tmp, tag + "_single",
                                                *overrides)
            del single
            got = os.path.join(tmp, tag + "_faulted")
            argv = [C.LM_SAMPLE, *C.PARALLEL_110M, *overrides,
                    *C.parallel_axes_args(axes), "--seed", "1337", "-d",
                    "cuda", "--transport", "gloo-host", "--no-stats",
                    "--export-inference", got]
            parallel.spawn(faulted_rank, 2, args=(fault, argv),
                           timeout_s=900.0)
            errs = C.archive_errors(numpy, got, want, start)
            worst = max(errs.values())
            row = {"part": tag, "fault": fault, "card": card,
                   "movement_max_rel_err": worst,
                   "bar": C.PARALLEL_DP_RTOL,
                   "worst_tensors": sorted(errs.items(),
                                           key=lambda kv: -kv[1])[:5]}
            print(json.dumps(row), flush=True)
            with open(log, "a") as f:
                f.write(json.dumps(row) + "\n")
            if not worst > C.PARALLEL_DP_RTOL:
                bad.append(tag)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
