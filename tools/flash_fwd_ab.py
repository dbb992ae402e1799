#!/usr/bin/env python3
"""Compare two versions of the bf16 flash forward on a CUDA card.

    python3 tools/flash_fwd_ab.py OLD.cu NEW.cu

Each source is a copy of ``veles_torch/csrc/flash_fwd_sm90.cu`` (entry
``veles_flash_fwd_sm90``) or of a ``flash_attention.cu`` whose
``veles_flash_fwd`` still takes bf16 (the ``mma.sync`` forward before the
wgmma one). Builds both with the port's nvcc flags (``csrc/`` on the
include path, for the shared header), checks that two launches of NEW
agree bit for bit, reports whether NEW agrees with OLD bit for bit, and
holds NEW against the plain
version at ragged, causal and non-causal shapes of every head dim, both
variants (``pipeline`` off and on) and the bf16 accumulator; then times
both in turns (old, new, new, old; L2 flushed) at the 110M and 110M_s8k
attention shapes, both variants. Prints one JSON line per case; needs one
card. Fails (exit 1) if NEW repeats no bits or leaves the tolerance.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CHECKS = (((2, 3, 200, 64), True), ((2, 3, 200, 64), False),
          ((64, 4, 32, 16), True), ((2, 2, 77, 16), False),
          ((4, 4, 256, 32), False), ((2, 3, 200, 128), True),
          ((2, 3, 200, 128), False))
TIMED = ((8, 12, 512, 64), (4, 12, 8192, 64))
#: scaled error against the plain version (chip_smoke.FLASH_VS_PLAIN_TOL
#: for the f32 chain; the bf16 chain rounds per K tile, the plain version
#: once: chip_smoke.FLASH_ACC_BF16_TOL)
TOL, ACC_TOL = 2e-2, 0.2


def build(sources):
    """{name: (ctypes library, sm90)} of {name: source text}, built in
    parallel; ``sm90`` names the entry point the library exports."""
    import chip_smoke as C
    from veles_torch import kernels
    from veles_torch.znicz.ops import flash_attention as FA
    # beside chip_smoke.py's traces and logs (git ignores the directory)
    paths = kernels.build_copies(sources,
                                 os.path.join(C.OUT_DIR, "flash_fwd_ab"))
    libs = {}
    for name, path in paths.items():
        sm90 = "veles_flash_fwd_sm90" in sources[name]
        libs[name] = (kernels.open_library(
            path, FA._SM90_FWD_SIGNATURES if sm90 else FA._SIGNATURES), sm90)
    return libs


def launcher(torch, lib, sm90, q, k, v, causal, pipeline, acc_bf16):
    """A call of ``lib``'s forward on these bf16 inputs -> (out, lse)."""
    from veles_torch.znicz.ops import flash_attention as FA
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, dh)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if sm90:
            rc = lib.veles_flash_fwd_sm90(*head, int(causal), int(pipeline),
                                          int(acc_bf16), FA.scale_for(dh),
                                          stream)
        else:
            rc = lib.veles_flash_fwd(*head, FA._DTYPE_CODES[q.dtype],
                                     int(causal), int(pipeline),
                                     int(acc_bf16), FA.scale_for(dh), stream)
        if rc:
            raise RuntimeError("launch failed: %d" % rc)
        return out, lse
    return call


def main(argv):
    import torch
    import chip_smoke as C
    from veles_torch.znicz.ops import flash_attention as FA
    if not torch.cuda.is_available():
        print("flash_fwd_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(C.card_line(), flush=True)
    timer = C.Timer(torch)
    texts = {}
    for name, path in zip(("old", "new"), argv):
        with open(path) as f:
            texts[name] = f.read()
    libs = build(texts)
    bad = []
    variants = ((False, False), (True, False), (False, True), (True, True))
    for shape, causal in CHECKS + tuple((t, True) for t in TIMED):
        q, k, v, _ = C.flash_inputs(torch, shape, torch.bfloat16)
        plain = {acc: FA.flash_attention_fwd_plain(
            q, k, v, causal, torch.bfloat16 if acc else None)
            for acc in (False, True)}
        for pipeline, acc in variants:
            calls = {n: launcher(torch, lib, sm90, q, k, v, causal, pipeline,
                                 acc) for n, (lib, sm90) in libs.items()}
            got = {n: [t.clone() for t in call()] for n, call in calls.items()}
            again = [t.clone() for t in calls["new"]()]
            torch.cuda.synchronize()
            row = {"shape": shape, "causal": causal, "pipeline": pipeline,
                   "acc_bf16": acc,
                   "new_equals_old": [torch.equal(a, b) for a, b in
                                      zip(got["new"], got["old"])],
                   "new_repeats": all(torch.equal(a, b)
                                      for a, b in zip(got["new"], again)),
                   "new_vs_plain": C.scaled_err(got["new"][0],
                                                plain[acc][0]),
                   "lse_vs_plain": (got["new"][1]
                                    - plain[acc][1]).abs().max().item()}
            if not row["new_repeats"] \
                    or not row["new_vs_plain"] <= (ACC_TOL if acc else TOL) \
                    or not row["lse_vs_plain"] <= C.LSE_ATOL:
                bad.append(row)
            if shape in TIMED and not acc:
                reps = 25 if shape[2] <= 1024 else 5
                row["ms"] = [[n, timer(calls[n], reps)]
                             for n in ("old", "new", "new", "old")]
                row["bound_ms"] = C.flash_bound_ms(shape, "fwd")[0]
            print(json.dumps(row), flush=True)
        del q, k, v, plain
        torch.cuda.empty_cache()
    if bad:
        print("flash_fwd_ab: NEW fails %d case(s)" % len(bad),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
