#!/usr/bin/env python3
"""Compare two versions of the bias-gradient kernel on a CUDA card.

    python3 tools/bias_grad_ab.py OLD.cu NEW.cu

Each source is a copy of ``veles_torch/csrc/bias_grad.cu``: one with the
package's interface (partials and tickets from the caller, launched
through ``ops/bias_grad.bias_grad``), or the two-pass kernel before it
(``git show 2187039:veles_torch/csrc/bias_grad.cu``, launched with its own
plan, repeated here as ``two_pass_plan``). Builds both with the port's
nvcc flags, then:

1. checks NEW at every shape and form (every activation at the MNIST and
   conv shapes, ``linear`` and ``tanh`` at the 110M LM step's shapes, and
   views two elements past a 16-byte boundary): two launches bitwise
   equal, within chip_smoke.TOLERANCE·Σ|dz| of the float64 math, one
   device kernel per call; whether NEW equals OLD bit for bit is
   reported only;
2. times OLD and NEW in turns (old, new, new, old; L2 flushed) at the LM
   shapes, (72900, 96) and (4097, 1000), both forms, beside
   ``err.sum(0, dtype=float32)`` and the byte bound;
3. trains the 110M LM row for its 2 epochs and profiles one train step
   with each version in turns (old, new, new, old): the bias gradient's
   device time and kernels per step by dtype, and its calls.

Prints one JSON line per case; needs one card. Fails (exit 1) if NEW
repeats no bits, leaves the tolerance or launches more than one kernel
per call.
"""

import contextlib
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: (N, K, dtype name, activations) checked
SMALL = ("linear", "softmax", "tanh", "relu", "strict_relu", "sigmoid")
CHECKS = [((100, 100), "bfloat16", SMALL), ((100, 10), "bfloat16", SMALL),
          ((100, 100), "float32", SMALL), ((72900, 96), "bfloat16", SMALL),
          ((4097, 1000), "bfloat16", SMALL), ((4097, 1000), "float32", SMALL),
          ((4096, 768), "bfloat16", ("linear", "tanh")),
          ((4096, 2304), "bfloat16", ("linear", "tanh")),
          ((4096, 16384), "bfloat16", ("linear", "tanh")),
          ((4096, 768), "float32", ("linear", "tanh")),
          ((4096, 3072), "float32", ("linear", "tanh"))]
#: shapes of CHECKS also run as views at a 2-element offset (scalar path)
MISALIGNED = ((4096, 768), (72900, 96))
#: timed (N, K, dtype name)
TIMED = [((4096, 768), "bfloat16"), ((4096, 2304), "bfloat16"),
         ((4096, 16384), "bfloat16"), ((4096, 768), "float32"),
         ((4096, 3072), "float32"), ((72900, 96), "bfloat16"),
         ((4097, 1000), "bfloat16")]
#: kernel names of the two designs in a profiler trace
KERNEL_NAMES = ("bias_grad_kernel", "partial_sums", "sum_partials")
TWO_PASS_SIGNATURES = {
    "veles_bias_grad": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]),
    "veles_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def two_pass_plan(n, k):
    """The launch of the two-pass kernel (its ``plan()``): pass 1's
    ``(bx, row_blocks, rows_per_block)``."""
    bx = 8
    while bx < k and bx < 256:
        bx *= 2
    col_tiles = -(-k // bx)
    row_blocks = min(-(-n // (256 // bx * 8)), max(1, 528 // col_tiles),
                     65535)
    rows_per_block = -(-n // max(row_blocks, 1))
    return bx, -(-n // rows_per_block), rows_per_block


def versions(torch, sources):
    """{name: bias_grad(err, y, activation)} of {name: source text}, the
    libraries built in parallel beside chip_smoke.py's logs."""
    import chip_smoke as C
    from veles_torch import kernels
    from veles_torch.znicz.ops import bias_grad as TBG
    paths = kernels.build_copies(sources,
                                 os.path.join(C.OUT_DIR, "bias_grad_ab"))
    fns = {}
    for name, path in paths.items():
        if "tickets" in sources[name]:
            lib = kernels.open_library(path, TBG._SIGNATURES)
            fns[name] = package_call(TBG, kernels, lib)
        else:
            lib = kernels.open_library(path, TWO_PASS_SIGNATURES)
            fns[name] = two_pass_call(torch, TBG, lib)
    return fns


def package_call(TBG, kernels, lib):
    """``ops/bias_grad.bias_grad`` launching ``lib``."""
    def call(err, y, act):
        saved = kernels._libs.get("bias_grad")
        kernels._libs["bias_grad"] = lib
        try:
            return TBG.bias_grad(err, y, act)
        finally:
            kernels._libs["bias_grad"] = saved
    return call


def two_pass_call(torch, TBG, lib):
    """The two-pass kernel's wrapper: pass 1 into partials, pass 2 where
    there is more than one row block."""
    def call(err, y, act):
        n, k = err.shape
        identity = TBG.A.is_identity(act)
        bx, row_blocks, rows_per_block = two_pass_plan(n, k)
        out = torch.empty(k, dtype=torch.float32, device=err.device)
        partials = torch.empty((row_blocks, k) if row_blocks > 1 else (0,),
                               dtype=torch.float32, device=err.device)
        rc = lib.veles_bias_grad(
            err.data_ptr(), None if identity else y.data_ptr(),
            partials.data_ptr() if row_blocks > 1 else None, out.data_ptr(),
            n, k, TBG._DTYPE_CODES[err.dtype], TBG._ACT_CODES[act], bx,
            row_blocks, rows_per_block,
            torch.cuda.current_stream(err.device).cuda_stream)
        if rc:
            raise RuntimeError("two-pass launch failed: %d" % rc)
        return out
    return call


def misaligned(torch, t):
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[2:2 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def kernels_in(torch, fn, name):
    """{kernel name: (count, ms)} of the device kernels ``fn()`` runs,
    from a torch.profiler trace (chiprun_out/<name>)."""
    import chip_smoke as C
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return C.device_trace(prof, name)


def check(torch, fns, bad):
    """Part 1: NEW's bits, accuracy and launches per call."""
    import chip_smoke as C
    from veles_torch.znicz.ops import activations as A
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    cases = [(shape, dname, acts, False) for shape, dname, acts in CHECKS]
    cases += [(shape, dname, ("linear", "tanh"), True)
              for shape, dname, _ in CHECKS if shape in MISALIGNED]
    for (n, k), dname, acts, offset in cases:
        dtype = getattr(torch, dname)
        err = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
        y = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
        if offset:
            err, y = misaligned(torch, err), misaligned(torch, y)
        for act in acts:
            new = fns["new"](err, y, act)
            again = fns["new"](err, y, act)
            old = fns["old"](err, y, act)
            torch.cuda.synchronize()
            d = A.ACTIVATIONS[act][1](y.double())
            dz = err.double() if isinstance(d, float) else err.double() * d
            diff = (new.double() - dz.sum(0)).abs()
            ratio = (diff / (C.TOLERANCE * dz.abs().sum(0)).clamp_min(
                1e-30)).max().item()
            _, _, by_name, _ = kernels_in(
                torch, lambda: fns["new"](err, y, act), "bias_grad_ab.json")
            launched = sum(c for op, (c, _) in by_name.items()
                           if any(n_ in op for n_ in KERNEL_NAMES))
            row = {"shape": [n, k], "dtype": dname, "activation": act,
                   "offset": offset, "new_repeats": torch.equal(new, again),
                   "new_equals_old": torch.equal(new, old),
                   "max_abs_err": diff.max().item(), "worst_ratio": ratio,
                   "new_kernels_per_call": launched}
            if not row["new_repeats"] or not ratio <= 1.0 or launched != 1:
                bad.append(row)
            print(json.dumps(row), flush=True)
        del err, y
        torch.cuda.empty_cache()


def time_turns(torch, fns, timer):
    """Part 2: OLD and NEW in turns, with err.sum and the bound."""
    import chip_smoke as C
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for (n, k), dname in TIMED:
        dtype = getattr(torch, dname)
        err = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
        y = torch.randn((n, k), generator=gen, device="cuda").to(dtype)
        for act in ("linear", "tanh"):
            row = {"shape": [n, k], "dtype": dname, "activation": act,
                   "ms": [[v, timer(lambda: fns[v](err, y, act))]
                          for v in ("old", "new", "new", "old")]}
            row["bound_ms"], row["bound_by"] = C.bound_ms(
                n, k, err.element_size(), act)
            if act == "linear":
                row["err_sum_ms"] = timer(
                    lambda: err.sum(0, dtype=torch.float32))
            print(json.dumps(row), flush=True)
        del err, y
        torch.cuda.empty_cache()


@contextlib.contextmanager
def routed(fn):
    """Every unit of the port calls ``fn`` for its bias gradient."""
    from veles_torch.znicz.ops import attention, gd, layernorm
    mods = (attention, gd, layernorm)
    saved = [m.bias_grad for m in mods]
    for m in mods:
        m.bias_grad = fn
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.bias_grad = f


def lm_step(torch, fns):
    """Part 3: one 110M train step per version, in turns, profiled."""
    import chip_smoke as C
    wf, _, _ = C.run_lm(torch, "110M", "cuda", *C.LM_110M,
                        valid_must_fall=False)
    batch = C.lm_batch(torch, wf)
    for i, name in enumerate(("old", "new", "new", "old")):
        calls = []

        def counted(err, y, act, fn=fns[name]):
            calls.append(act)
            return fn(err, y, act)

        with routed(counted):
            wf.step.train_minibatch(*batch)
            calls.clear()
            busy_ms, _, by_name, path = kernels_in(
                torch, lambda: wf.step.train_minibatch(*batch),
                "bias_grad_ab_lm_step_%d_%s.json" % (i, name))
        rows = {}
        for op, (count, ms) in by_name.items():
            kernel = next((k for k in KERNEL_NAMES if k in op), None)
            if kernel is None:
                continue
            dname = "bfloat16" if "bfloat16" in op \
                else "float16" if "__half" in op else "float32"
            row = rows.setdefault("%s[%s]" % (kernel, dname),
                                  {"launches": 0, "ms": 0.0})
            row["launches"] += count
            row["ms"] += ms
        print(json.dumps({
            "lm_step": name, "calls": len(calls),
            "bias_grad_ms": sum(r["ms"] for r in rows.values()),
            "bias_grad_launches": sum(r["launches"] for r in rows.values()),
            "device_busy_ms": busy_ms, "kernels": rows, "trace": path}),
            flush=True)


def main(argv):
    import torch
    import chip_smoke as C
    if not torch.cuda.is_available():
        print("bias_grad_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(C.card_line(), flush=True)
    texts = {}
    for name, path in zip(("old", "new"), argv):
        with open(path) as f:
            texts[name] = f.read()
    fns = versions(torch, texts)
    bad = []
    check(torch, fns, bad)
    time_turns(torch, fns, C.Timer(torch))
    lm_step(torch, fns)
    if bad:
        print("bias_grad_ab: NEW fails %d case(s)" % len(bad),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
