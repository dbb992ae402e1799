#!/usr/bin/env python3
"""How often a torch.profiler trace of one short CUDA call misses the
call's kernel, on a CUDA card.

    python3 tools/profiler_trace_check.py [SESSIONS]

The card tests and ``chip_smoke.py`` read "one device kernel per call"
from a profiler trace around the call (tests/test_torch_cuda.py
``_device_kernels``). This opens SESSIONS (default 200) profiler sessions
in one process, each around one bias-gradient call at the LM's (4096,
3072) f32 shape, and counts the sessions whose trace holds no kernel
event, by position: the process's first session, and the rest. Prints
one JSON line; needs one card.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def kernels_in(prof, path):
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from veles_torch import kernels
    from veles_torch.znicz.ops.bias_grad import bias_grad
    if not torch.cuda.is_available():
        print("profiler_trace_check: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    sessions = int(argv[0]) if argv else 200
    kernels.build(["bias_grad"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    err = torch.randn((4096, 3072), generator=gen, device="cuda")
    y = torch.randn((4096, 3072), generator=gen, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": torch.cuda.get_device_name(0), "sessions": sessions,
           "torch": torch.__version__}
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        for _ in range(sessions):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                bias_grad(err, y, "linear")
                torch.cuda.synchronize()
            counts.append(len(kernels_in(prof, path)))
    out.update({"first_session_kernels": counts[0],
                "empty_sessions": sum(c == 0 for c in counts),
                "empty_after_first": sum(c == 0 for c in counts[1:]),
                "kernels_histogram": {str(k): counts.count(k)
                                      for k in sorted(set(counts))}})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
