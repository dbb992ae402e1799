#!/usr/bin/env python3
"""Compare versions of the bf16 flash backward on a CUDA card.

    python3 tools/flash_bwd_ab.py OLD.cu NEW.cu   # A/B of two sources
    python3 tools/flash_bwd_ab.py --ablate         # where a step's time goes
    python3 tools/flash_bwd_ab.py --pair OLD.cu    # the two-kernel pair

The A/B builds both sources (each a copy of
``veles_torch/csrc/flash_bwd_sm90.cu``) with the port's nvcc flags, checks
that NEW agrees with OLD bit for bit and with the plain version at
ragged, causal and non-causal shapes of every head dim, and times both in
turns (old, new, new, old; L2 flushed) at the 110M and 110M_s8k
attention shapes. ``--ablate`` builds the checked-in source and copies of
it with one part of the work cut out (results then wrong; only the times
mean anything) and times each: the gap to the full kernel is what that
part costs. ``--pair`` compares the two-kernel backward (``fused=False``):
OLD is a ``flash_attention.cu`` whose ``veles_flash_bwd_dq`` and
``veles_flash_bwd_dkv`` still take bf16 (the ``mma.sync`` pair, e.g. ``git
show 80e5468:veles_torch/csrc/flash_attention.cu``), built with
``kernels.build_copies``, against the checked-in wgmma kernels
(``flash_dq_sm90.cu`` and ``flash_bwd_sm90.cu`` without dq, through
``flash_attention_dq`` and ``flash_attention_dkv``); it holds the new
kernels to their plain versions, two launches and, for dk and dv, the
fused kernel's bits, and times dq, dk/dv and the pair in turns (old,
new, new, old; L2 flushed) beside the fused kernel and SDPA's backward.
Prints one JSON line per shape; needs one card; ``--pair`` exits 1 if a
new kernel fails a check.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = os.path.join(HERE, "veles_torch", "csrc", "flash_bwd_sm90.cu")
#: (name, [(text in the source, its replacement)]): each cuts one part
ABLATIONS = (
    ("full", []),
    ("no_wait", [("if (seen >= target) {", "if (true) {")]),
    ("no_read", [("        if (kt != first) {\n          // probe the counter",
                  "        if (false) {\n          // probe the counter")]),
    ("no_writer", [("        if (kt < 0) {\n          break;\n        }\n",
                    "        if (kt < 0) {\n          break;\n        }\n"
                    "        __syncwarp();\n        if (lane == 0) {\n"
                    "          mbar_arrive(&dq_empty[writer]);\n        }\n"
                    "        continue;\n")]),
    ("no_exp", [("float p = expf(x - lse_s[qi]);",
                 "float p = x - lse_s[qi];")]),
)
CHECKS = (((2, 3, 200, 64), True), ((2, 3, 200, 64), False),
          ((64, 4, 32, 16), True), ((4, 4, 256, 32), False),
          ((2, 3, 200, 128), True), ((2, 3, 200, 128), False))
TIMED = ((8, 12, 512, 64), (4, 12, 8192, 64))


def build(sources):
    """{name: ctypes library} of {name: source text}, built in parallel."""
    import chip_smoke as C
    from veles_torch import kernels
    from veles_torch.znicz.ops import flash_attention as FA
    # beside chip_smoke.py's traces and logs (git ignores the directory)
    paths = kernels.build_copies(sources,
                                 os.path.join(C.OUT_DIR, "flash_bwd_ab"))
    # the fused entry alone: an older copy may lack the dk/dv one
    fused = {n: FA._SM90_SIGNATURES[n]
             for n in ("veles_flash_bwd_sm90", "veles_flash_error_string")}
    return {name: kernels.open_library(path, fused)
            for name, path in paths.items()}


def launcher(torch, lib, q, k, v, dout, lse, delta, causal):
    """A call of ``lib``'s kernel on these inputs -> (dq, dk, dv)."""
    from veles_torch.znicz.ops import flash_attention as FA
    b, h, s, dh = q.shape
    n_qt = FA.n_tiles(s)
    grads = [torch.empty_like(q) for _ in range(3)]
    acc = torch.empty((b * h, n_qt * FA.BLOCK_Q, dh), dtype=torch.float32,
                      device=q.device)
    sync = torch.empty(1 + b * h * n_qt, dtype=torch.int32, device=q.device)

    def call():
        sync.zero_()
        rc = lib.veles_flash_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads),
            acc.data_ptr(), sync.data_ptr(), b * h, s, dh, int(causal),
            FA.scale_for(dh), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("launch failed: %d" % rc)
        return grads
    return call


def inputs(torch, shape, causal):
    import chip_smoke as C
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, dout = C.flash_inputs(torch, shape, torch.bfloat16)
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    return q, k, v, dout, out, lse, FA.row_delta(out, dout)


def pair_ab(torch, timer, old_path):
    """``--pair``: the old two-kernel pair against the checked-in one."""
    import threading
    import torch.nn.functional as F
    import chip_smoke as C
    from veles_torch import kernels
    from veles_torch.znicz.ops import flash_attention as FA
    with open(old_path) as f:
        text = f.read()
    new_build = threading.Thread(
        target=kernels.build, args=(["flash_dq_sm90", "flash_bwd_sm90"],))
    new_build.start()
    paths = kernels.build_copies({"old": text},
                                 os.path.join(C.OUT_DIR, "flash_pair_ab"))
    new_build.join()
    old = kernels.open_library(paths["old"], {
        n: FA._SIGNATURES[n] for n in ("veles_flash_bwd_dq",
                                       "veles_flash_bwd_dkv",
                                       "veles_flash_error_string")})
    bad = []
    for shape, causal in CHECKS + tuple((t, True) for t in TIMED):
        q, k, v, dout, out, lse, delta = inputs(torch, shape, causal)
        b, h, s, dh = shape
        grads = [torch.empty_like(q) for _ in range(3)]
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        tail = (b * h, s, dh, FA._DTYPE_CODES[torch.bfloat16], int(causal),
                FA.scale_for(dh), torch.cuda.current_stream().cuda_stream)

        def old_dq():
            if old.veles_flash_bwd_dq(*head, grads[0].data_ptr(), *tail):
                raise RuntimeError("old dq launch failed")

        def old_dkv():
            if old.veles_flash_bwd_dkv(*head, grads[1].data_ptr(),
                                       grads[2].data_ptr(), *tail):
                raise RuntimeError("old dk/dv launch failed")

        def new_dq():
            return FA.flash_attention_dq(q, k, v, out, lse, dout, causal,
                                         delta)

        def new_dkv():
            return FA.flash_attention_dkv(q, k, v, out, lse, dout, causal,
                                          delta)

        calls = {"dq": {"old": old_dq, "new": new_dq},
                 "dkv": {"old": old_dkv, "new": new_dkv},
                 "pair": {"old": lambda: (old_dq(), old_dkv()),
                          "new": lambda: (new_dq(), new_dkv())}}
        old_dq()
        old_dkv()
        got = [new_dq(), *new_dkv()]
        again = [new_dq(), *new_dkv()]
        fused = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       delta)
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                            delta)
        torch.cuda.synchronize()
        row = {"shape": shape, "causal": causal,
               "new_repeats": all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
               "new_dk_dv_equal_fused": all(
                   torch.equal(a, b) for a, b in zip(got[1:], fused[1:])),
               "new_vs_plain": [C.scaled_err(a, b)
                                for a, b in zip(got, want)],
               "old_vs_plain": [C.scaled_err(a, b)
                                for a, b in zip(grads, want)]}
        if not row["new_repeats"] or not row["new_dk_dv_equal_fused"] \
                or not max(row["new_vs_plain"]) <= C.FLASH_VS_PLAIN_TOL[
                    "bfloat16"]:
            bad.append(row)
        if shape in TIMED and causal:
            reps = 25 if s <= 1024 else 5
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qr, kr, vr,
                                                     is_causal=True)

            def others():
                return {"fused": timer(lambda: FA.flash_attention_bwd(
                    q, k, v, out, lse, dout, causal, delta), reps),
                    "sdpa_bwd": timer(lambda: torch.autograd.grad(
                        lib_out, (qr, kr, vr), dout, retain_graph=True),
                        reps)}
            row["before"] = others()
            for form, fns in calls.items():
                row[form + "_ms"] = [[n, timer(fns[n], reps)]
                                     for n in ("old", "new", "new", "old")]
                row[form + "_bound_ms"] = C.flash_bound_ms(shape, form)[0]
            row["after"] = others()
            del qr, kr, vr, lib_out
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, delta, grads, got, again, fused, want
        torch.cuda.empty_cache()
    if bad:
        print("flash_bwd_ab --pair: the new pair fails %d case(s)"
              % len(bad), file=sys.stderr)
        return 1
    return 0


def main(argv):
    import torch
    import chip_smoke as C
    from veles_torch.znicz.ops import flash_attention as FA
    if not torch.cuda.is_available():
        print("flash_bwd_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(C.card_line(), flush=True)
    timer = C.Timer(torch)
    if len(argv) == 2 and argv[0] == "--pair":
        return pair_ab(torch, timer, argv[1])
    if argv == ["--ablate"]:
        with open(SOURCE) as f:
            text = f.read()
        sources = {}
        for name, edits in ABLATIONS:
            variant = text
            for old, new in edits:
                if old not in variant:
                    raise ValueError("%s: %r is not in the source"
                                     % (name, old))
                variant = variant.replace(old, new)
            sources[name] = variant
        libs = build(sources)
        for shape in TIMED:
            q, k, v, dout, _, lse, delta = inputs(torch, shape, True)
            reps = 25 if shape[2] <= 1024 else 5
            row = {"shape": shape}
            for name, lib in libs.items():
                call = launcher(torch, lib, q, k, v, dout, lse, delta, True)
                row[name] = [timer(call, reps) for _ in range(2)]
            print(json.dumps(row), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    texts = {}
    for name, path in zip(("old", "new"), argv):
        with open(path) as f:
            texts[name] = f.read()
    libs = build(texts)
    for shape, causal in CHECKS + tuple((t, True) for t in TIMED):
        q, k, v, dout, out, lse, delta = inputs(torch, shape, causal)
        calls = {n: launcher(torch, lib, q, k, v, dout, lse, delta, causal)
                 for n, lib in libs.items()}
        got = {n: [t.clone() for t in call()] for n, call in calls.items()}
        again = [t.clone() for t in calls["new"]()]
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
        row = {"shape": shape, "causal": causal,
               "new_equals_old": [torch.equal(a, b) for a, b in
                                  zip(got["new"], got["old"])],
               "new_repeats": all(torch.equal(a, b)
                                  for a, b in zip(got["new"], again)),
               "new_vs_plain": [C.scaled_err(a, b)
                                for a, b in zip(got["new"], want)]}
        if shape in TIMED:
            reps = 25 if shape[2] <= 1024 else 5
            row["ms"] = [[n, timer(calls[n], reps)]
                         for n in ("old", "new", "new", "old")]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
