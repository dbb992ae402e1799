#!/usr/bin/env python3
"""The port's parallel modes over NCCL, one rank per card.

    python3 tools/parallel_nccl.py [N]

Needs N cards (default: every visible card, at least 2; N divides the
110M row's 12 heads). It runs ``chip_smoke.py``'s phase ``parallel``
(``chip_smoke.check_parallel``) with N ranks and ``--transport nccl``,
rank r on card r, where the script itself runs 2 ranks sharing one card
over gloo-host: (a) the 110M row under ``data=N`` in f32 and (a') under
the bf16 policy, (c) ``model=N`` and, with N ≥ 4, ``data=2`` ×
``model=N/2``, each held against a one-process run on card 0 (every
tensor's movement, the losses, each rank's launches, the collectives a
step); (b) the 110M_s8k row at 6 layers under ``seq=N`` with exact launch
and hop counts, and one MHA layer's ring against the single-card flash
path; (d) ``graft_entry.dryrun_multichip(N)`` (every leg, EP and PP
among them); then phase ``parallel_ep_pp`` (``chip_smoke.
check_parallel_ep_pp``): the 110M MoE under ``expert=N`` with gather
routing and the all-to-all exchange and, with N ≥ 4, ``expert=2`` ×
``data=N/2``; the stacked 110M under ``pipe=N`` with GPipe and 1F1B and,
with N ≥ 4, ``pipe=2`` × ``data=N/2`` (N divides the 12 layers and the 8
experts), each held against its one-process run on card 0.

Prints one JSON line per part (each rank's step ms, collective bytes and
host seconds beside the cards' names and power limits), also written to
``parallel_nccl.jsonl`` in ``chip_smoke.OUT_DIR``; the last line is
``{"ok": true, ...}``. Any check that fails ends the run with exit 1.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def cards_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(sorted(set(out.stdout.strip().splitlines())))


def main(argv):
    import torch
    import chip_smoke as C
    from veles_torch import kernels
    n = int(argv[0]) if argv else torch.cuda.device_count()
    if n < 2 or torch.cuda.device_count() < n:
        print("parallel_nccl: needs %d cards, sees %d"
              % (max(n, 2), torch.cuda.device_count()), file=sys.stderr)
        return 1
    C.PARALLEL_TRANSPORT = "nccl"
    os.makedirs(C.OUT_DIR, exist_ok=True)
    C.LOG_PATH = os.path.join(C.OUT_DIR, "parallel_nccl.jsonl")
    open(C.LOG_PATH, "w").close()
    cards = cards_line()
    C.card_line = lambda: cards
    print(cards, flush=True)
    kernels.build()
    C.check_parallel(torch, n)
    C.check_parallel_ep_pp(torch, n)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
