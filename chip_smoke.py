#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``veles_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing JSON lines; any failure ends the run non-zero:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compiles every kernel source in ``veles_torch/csrc`` with
   nvcc for sm_90a, all at once, and reports the seconds and each
   kernel's registers and spilled bytes (ptxas; the full reports go to
   ``nvcc_<source>.log`` in the output directory of phase 7); where
   ``cuobjdump`` exists, the count of ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA load) instructions in each kernel of the bf16 forward
   (``flash_fwd_sm90.cu``) and fused backward (``flash_bwd_sm90.cu``),
   failing if one has none of either;
3. kernels — holds the bias-gradient kernel against its plain PyTorch
   version on the card: every activation, float32 and bfloat16 inputs,
   at the MNIST shapes and two large ones; ``linear`` and ``tanh`` at the
   110M LM step's shapes (``LM_SHAPES``) in the dtype the LM gives each.
   The tolerance per column is ``1e-4·Σ_n|dz[n,k]|`` against the plain
   math in float64 (f32 sums taken in another order); two launches must
   agree bitwise. Times the kernel, its plain version and, for the
   identity form, the one PyTorch call that computes it, with the L2
   cache flushed before every launch, beside the least time the card
   could take, at every shape;
4. flash_kernels — the five flash-attention kernels (forward and
   pipelined forward: for bf16 the wgmma + TMA kernel of
   ``flash_fwd_sm90.cu``, for f32 the scalar one; fused backward: for bf16
   the wgmma + TMA kernel of ``flash_bwd_sm90.cu``, for f32 the chunked
   one; and the two-kernel backward's dq and dk/dv kernels) and their
   plain versions against the
   float64 math from the same inputs, f32 and bf16, causal and not, at
   (B, H, S, dh) = (64, 4, 32, 16) (the LM sample), (8, 12, 512, 64)
   (the 110M row), (2, 3, 200, 64) (ragged S), (4, 4, 256, 32) and
   (2, 3, 200, 128) (the other head dims, the second ragged) and
   (4, 12, 8192, 64) (the 110M_s8k shape). Every element of out, dq, dk and dv is held to
   its own size and its row's (``scaled_err``: |got − ref| ≤ tol·(|ref|
   + rms of the row) + ATOL_SHARE·max|ref|, a row per (b, h, query) or
   (b, h, key)), since causal rows shrink with their position and a
   tensor-wide scale would leave the later rows' work unchecked; tol
   (``FLASH_TOL``) comes from the sound readings on the card; lse within
   1e-3; the bf16-accumulated forward, pipelined or not, to
   ``FLASH_ACC_BF16_TOL``. Kernel and plain version must agree with each
   other to ``FLASH_VS_PLAIN_TOL``, and two launches bitwise; the two-kernel
   backward (``fused=False``) also agrees with the fused kernel to
   ``FLASH_VS_PLAIN_TOL`` (whether its dk and dv equal the fused
   kernel's bit for bit is reported only: the bf16 fused kernel sums in
   another order since it runs on wgmma), and a hoisted delta changes no
   bit of it;
5. flash_kernel_times — at the 110M and 110M_s8k shapes, bf16, causal:
   kernel, plain version and ``F.scaled_dot_product_attention`` (its
   autograd backward for the backward, and for the two-kernel pair: no
   one PyTorch call computes dq alone or dk/dv alone), L2 flushed,
   beside the bound; then the fused backward and the pair in turns
   (fused, pair, pair, fused): the A/B of the two backward forms;
6. mnist   — trains the MNIST sample through the CLI entry point at its
   full width (784-100-10, minibatch 100, 6000/1000 samples), 3 epochs
   at seed 1337 on ``cuda`` and on ``cpu``. The bias-gradient kernel must
   have launched twice per train step (once per GD unit); the final
   validation error must be below 0.15 and within 0.02 of the CPU run;
7. profile — one more MNIST epoch under ``torch.profiler``: the
   device's busy time and idle share, launches per step, the top
   device operations, the bias-gradient kernel's device launches and
   time by dtype, read from the trace by kernel name — one device launch
   per call, or the run fails (trace in
   ``chiprun_out/mnist_epoch_trace.json``);
8. lm      — the transformer LM through the CLI entry point with
   ``attn_impl=pallas`` at seed 1337: (a) the sample's width on cuda
   and cpu for its 8 epochs — the validation loss must fall and end
   within ``LM_CPU_TOLERANCE`` of the CPU run's; (b) the same on cuda
   with ``attn_pipeline=True`` and with ``attn_acc="bf16"``; (c) the
   full-width 110M row (dim 768, 12 heads, 12 layers, ffn 3072, vocab
   16384, S 512, minibatch 8; 64/16 samples, 2 epochs) on cuda: every
   parameter finite and the train loss falling (16 steps on a
   16384-token vocabulary need not lower the validation loss yet),
   tokens/s and step ms. Every run counts the launches from 0:
   forward = layers × (train + eval steps), fused backward = layers ×
   train steps, pipelined = the forward count in the pipelined run and
   0 elsewhere, the two-kernel backward's kernels 0 (the LM takes the
   fused backward, as the reference's does), and the bias-gradient
   kernel's identity form (layers·6 + 1) per train step;
   flash_bwd_two_kernel — on each of the 110M run's 12 attention units'
   forward cache (q, k, v, out, lse; bf16 (8, 12, 512, 64)) with a dout
   from a seeded generator, the fused and the two-kernel backward
   (``flash_attention_bwd(fused=False)``) agree to
   ``FLASH_VS_PLAIN_TOL`` (how many units' dk and dv agree bit for bit
   is reported only); counted from 0: 12 launches each of the fused, dq
   and dk/dv kernels;
9. lm_profile — one full-width 110M train step under
   ``torch.profiler``: device busy time, idle share, top device
   operations, the flash kernels' share, and the bias-gradient kernel's
   device time and launches by dtype, one device launch per call (trace
   ``lm_step_trace.json`` in the output directory of phase 7);
10. the ``kernels`` summary line, the card line, and last
    ``{"ok": true, "device": {...}}``.

Every JSON line also goes to ``chip_smoke.jsonl`` in that directory.
"""

import functools
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
ACTIVATIONS = ("linear", "softmax", "tanh", "relu", "strict_relu",
               "sigmoid")
SHAPES = ((100, 100), (100, 10), (72900, 96), (4097, 1000))
#: the bias gradients of the 110M LM step (N = B·S = 4096 rows): the
#: attention and FFN output biases (768, bf16), the qkv bias (2304,
#: bf16), the vocab head (16384, bf16), the layer norms' (768, f32) and
#: the FFN's hidden bias (3072, f32)
LM_SHAPES = (((4096, 768), "bfloat16"), ((4096, 2304), "bfloat16"),
             ((4096, 16384), "bfloat16"), ((4096, 768), "float32"),
             ((4096, 3072), "float32"))
#: activations checked at LM_SHAPES: the identity form the LM runs and a
#: masked one (every activation runs at SHAPES)
LM_ACTIVATIONS = ("linear", "tanh")
#: the bias-gradient kernel in a profiler trace (``bias_grad_kernel<T,
#: ACT, VEC>`` in csrc/bias_grad.cu)
BIAS_GRAD_KERNEL = "bias_grad_kernel"
#: f32 operations per element of the masked sum, by activation
#: (derivative, multiply by err, add); the identity form only adds
OPS_PER_ELEMENT = {"linear": 1, "softmax": 1, "tanh": 5, "relu": 4,
                   "strict_relu": 3, "sigmoid": 4}
#: (form, activation timed, main-path shape, TPU kernel replaced)
FORMS = (("identity", "linear", (100, 10),
          "veles/znicz_tpu/ops/pallas_grads.py:95"),
         ("masked", "tanh", (100, 100),
          "veles/znicz_tpu/ops/pallas_grads.py:76"))
TOLERANCE = 1e-4
#: (B, H, S, dh) of the flash checks: the LM sample's attention, the
#: 110M row, a ragged S, the 110M_s8k row (bench.py LM_ROWS)
FLASH_SHAPES = ((64, 4, 32, 16), (8, 12, 512, 64), (2, 3, 200, 64),
                (4, 4, 256, 32), (2, 3, 200, 128), (4, 12, 8192, 64))
#: timed shapes (bf16, causal) and the main path's (the 110M row)
FLASH_TIMED = ((8, 12, 512, 64), (4, 12, 8192, 64))
FLASH_MAIN = (8, 12, 512, 64)
#: limits of scaled_err, by input dtype, against the float64 math: each
#: element is held to its own size plus its row's rms (one row per (b, h,
#: query) of out and dq, per (b, h, key) of dk and dv), since causal rows
#: shrink with their position (out row i is about 1/√i in size) and a
#: tensor-wide scale would leave the later rows' work unchecked. Sound
#: kernels on an H100 read at most 0.0149 (bf16) and 5.3e-6 (f32) at the
#: four FLASH_SHAPES; a V row dropped from the second half's off-diagonal
#: tiles of the forward read 1.51, a dropped diagonal mask 1.3e3. The
#: bf16-accumulated forward rounds its accumulator once per K tile, so
#: its error grows with the number of K tiles: 0.096 at S=8192 non-causal
#: with the 64-key tiles of the mma.sync kernel (the wgmma kernel's are
#: 128 keys).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_ACC_BF16_TOL = 0.2
#: kernel against plain version, both rounding p and ds to the storage
#: dtype (values on either side of a bf16 rounding step differ by one
#: bf16 ulp); sound readings at most 0.0114 (bf16), 4.1e-6 (f32)
FLASH_VS_PLAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-3
#: absolute allowance, as a share of max|ref|, for an f32 sum's rounding
#: where the reference is 0 (dq of row 0 in a causal run: ds = p·(dp −
#: delta) = 0 exactly)
ATOL_SHARE = 1e-6
#: (summary name, source of the bf16 kernel, TPU kernel replaced)
FLASH_SOURCE = "veles_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (
    ("flash_fwd", "veles_torch/csrc/flash_fwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:161"),
    ("flash_fwd_pipe", "veles_torch/csrc/flash_fwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:203"),
    ("flash_bwd_fused", "veles_torch/csrc/flash_bwd_sm90.cu",
     "veles/znicz_tpu/parallel/pallas_attention.py:384"),
    ("flash_bwd_dq", FLASH_SOURCE,
     "veles/znicz_tpu/parallel/pallas_attention.py:278"),
    ("flash_bwd_dkv", FLASH_SOURCE,
     "veles/znicz_tpu/parallel/pallas_attention.py:324"))
#: the libraries of the bf16 forward and fused backward, and the
#: instructions each of their kernels must hold: wgmma and TMA loads
SM90_LIBRARIES = ("flash_fwd_sm90", "flash_bwd_sm90")
SM90_OPCODES = ("HGMMA", "UTMALDG")
#: per form: operations as multiples of B·H·S²·dh/2 (causal: each block
#: product is 2·S²·dh/2 operations), bf16 (B, H, S, dh) tensors and f32
#: (B, H, S) rows moved. The pair (dq and dk/dv kernels) computes what
#: the fused backward computes, with s and dp recomputed in each kernel:
#: 7 products, not 5; as one function it moves the fused backward's
#: bytes, though its two kernels between them read 11 tensors and 4 rows.
FLASH_WORK = {"fwd": (4, 4, 1), "bwd": (10, 7, 2), "dq": (6, 5, 2),
              "dkv": (8, 6, 2), "pair": (14, 7, 2)}
LM_SAMPLE = os.path.join(HERE, "veles_torch", "znicz", "models",
                         "transformer_lm.py")
#: final validation loss of the LM sample, cuda vs cpu: the card runs
#: bf16 matmul inputs and activations, the CPU f32, and the loss drops
#: through a transition (epochs 4-6 at seed 1337) whose timing moves
#: with rounding
LM_CPU_TOLERANCE = 0.3
#: the 110M row of bench.py (LM_ROWS["110M"]) with the flash kernels,
#: its corpus cut to 64/16 sequences and 2 epochs
LM_110M = ("root.lm.loader.minibatch_size=8", "root.lm.loader.n_train=64",
           "root.lm.loader.n_valid=16", "root.lm.loader.seq_len=512",
           "root.lm.loader.vocab=16384", "root.lm.loader.max_period=8",
           "root.lm.model.dim=768", "root.lm.model.heads=12",
           "root.lm.model.layers=12", "root.lm.model.ffn_hidden=3072",
           "root.lm.model.attn_block=256", "root.lm.decision.max_epochs=2")
#: where traces and the full log go (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "chiprun_out")
#: every JSON line printed, in full (the end of stdout may be all that a
#: remote runner keeps)
LOG_PATH = os.path.join(OUT_DIR, "chip_smoke.jsonl")


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """``name<template ints,element type>`` of an Itanium-mangled kernel
    name: the last of its ``<length><identifier>`` parts, then the
    integer and element-type template arguments."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        name = mangled[pos:pos + int(n)]
        pos += int(n)
    head = mangled[pos:].split("Ev", 1)[0]
    args = re.findall(r"L[ib](\d+)E", head)
    if "bfloat16" in head:
        args.append("bf16")
    elif head.startswith("If"):
        args.append("f32")
    return "%s<%s>" % (name, ",".join(args))


def ptxas_report(log):
    """{kernel: [registers, spilled bytes stored + loaded]} from nvcc's
    ``-Xptxas -v`` report."""
    report, name, spills = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = [int(m.group(1)), spills]
            name = None
    return report


def sass_counts(kernels, library):
    """{kernel: {opcode: count}} of SM90_OPCODES in ``cuobjdump -sass``
    of the built ``library``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", kernels.library_path(library)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = dict.fromkeys(SM90_OPCODES, 0)
        elif name:
            for op in SM90_OPCODES:
                counts[name][op] += bool(re.search(r"\b%s\b" % op, line))
    return counts


def bound_ms(n, k, itemsize, activation):
    """Least time for the function on an H100: inputs read once, the
    (K,) f32 output written once, against the f32 operation count."""
    from veles_torch.znicz.ops import activations as A
    inputs = 1 if A.is_identity(activation) else 2
    nbytes = inputs * n * k * itemsize + 4 * k
    ops = OPS_PER_ELEMENT[activation] * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


class Timer:
    """Median device time of one call, the L2 cache flushed first."""

    def __init__(self, torch):
        self.torch = torch
        # larger than the 50 MB L2, so each launch starts cold
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps=25):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


def check_bias_grad(torch, err, y, act, forms):
    """One (shape, dtype, activation) of phase kernels: the kernel twice
    against the float64 math; -> max |error|."""
    from veles_torch.znicz.ops import activations as A
    from veles_torch.znicz.ops.bias_grad import bias_grad
    n, k = err.shape
    out = bias_grad(err, y, act)
    again = bias_grad(err, y, act)
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != (k,):
        fail("bias_grad %s %s: got %s %s"
             % (act, (n, k), out.dtype, tuple(out.shape)))
    if not torch.equal(out, again):
        fail("bias_grad %s %s %s: two launches differ"
             % (act, (n, k), err.dtype))
    d = A.ACTIVATIONS[act][1](y.double())
    dz = err.double() if isinstance(d, float) else err.double() * d
    diff = (out.double() - dz.sum(dim=0)).abs()
    limit = TOLERANCE * dz.abs().sum(dim=0)
    if not bool((diff <= limit).all()):
        fail("bias_grad %s %s %s: error %.3g over limit (worst ratio %.3g)"
             % (act, (n, k), err.dtype, diff.max().item(),
                (diff / limit.clamp_min(1e-30)).max().item()))
    form = "identity" if A.is_identity(act) else "masked"
    forms[form]["max_abs_err"] = max(forms[form]["max_abs_err"],
                                     diff.max().item())
    return diff.max().item()


def check_kernels(torch, timer):
    """Phase 3; -> {form: {"max_abs_err", and the main-path times}}."""
    from veles_torch.znicz.ops.bias_grad import bias_grad, bias_grad_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    forms = {form: {"max_abs_err": 0.0} for form, _, _, _ in FORMS}
    cases = [(shape, ("float32", "bfloat16"), ACTIVATIONS)
             for shape in SHAPES] + [
        (shape, (dname,), LM_ACTIVATIONS) for shape, dname in LM_SHAPES]
    for (n, k), dnames, acts in cases:
        base_err = torch.randn((n, k), generator=gen, device="cuda")
        base_y = torch.randn((n, k), generator=gen, device="cuda")
        for dname in dnames:
            dtype = getattr(torch, dname)
            err, y = base_err.to(dtype), base_y.to(dtype)
            worst = {act: check_bias_grad(torch, err, y, act, forms)
                     for act in acts}
            emit({"phase": "kernels", "shape": [n, k], "dtype": dname,
                  "max_abs_err": worst, "bitwise_repeat": True})
        # timings in the card's activation dtype, or the LM's for its
        # shapes
        dtype = getattr(torch, dnames[-1])
        err, y = base_err.to(dtype), base_y.to(dtype)
        for form, act, main_shape, _ in FORMS:
            row = {
                "kernel_ms": timer(lambda: bias_grad(err, y, act)),
                "plain_ms": timer(lambda: bias_grad_plain(err, y, act)),
                "library_ms": timer(
                    lambda: err.sum(0, dtype=torch.float32))
                if form == "identity" else None,
            }
            row["bound_ms"], row["bound_by"] = bound_ms(
                n, k, err.element_size(), act)
            emit({"phase": "kernel_times", "form": form,
                  "activation": act, "shape": [n, k], "dtype": dnames[-1],
                  **row})
            if (n, k) == main_shape:
                forms[form].update(row)
        del base_err, base_y, err, y
        torch.cuda.empty_cache()
    return forms


def run_mnist(torch, device):
    from veles_torch.__main__ import main as cli
    return cli([os.path.join(HERE, "veles_torch", "znicz", "models",
                             "mnist.py"),
                "root.mnist.decision.max_epochs=3", "--seed", "1337",
                "-d", device])


def check_mnist(torch, wf, name):
    history = wf.decision.history
    if len(history) != 3:
        fail("%s: %d epochs in the history, expected 3"
             % (name, len(history)))
    for unit, sub in wf.export_tree().items():
        for key, t in sub.items():
            if not bool(torch.isfinite(t.float()).all()):
                fail("%s: %s.%s is not finite" % (name, unit, key))
    shapes = {u.name: tuple(u.weights.shape) for u in wf.forwards}
    if list(shapes.values()) != [(784, 100), (100, 10)]:
        fail("%s: weight shapes %s" % (name, shapes))
    return history[-1]["validation"]["metric"]


def device_trace(prof, name):
    """Write the profile's Chrome trace to OUT_DIR/<name> and sum its
    device intervals (kernels, copies, memsets): -> (busy ms as the union
    of the intervals, device op count, {op name: (count, ms)}, path)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, None
    for lo, hi, _ in spans:
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    by_name = {}
    for lo, hi, op in spans:
        n, t = by_name.get(op, (0, 0.0))
        by_name[op] = (n + 1, t + (hi - lo) / 1e3)
    return busy_us / 1e3, len(spans), by_name, os.path.relpath(path, HERE)


def top_ops(by_name, n=8):
    return [{"name": op[:80], "count": c, "ms": t} for op, (c, t) in
            sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]]


def bias_grad_in_trace(by_name, calls, where):
    """The bias-gradient kernel's device launches and ms in a trace, by
    input dtype (read from the kernel name); fails unless the ``calls``
    to the wrapper in the traced window launched one kernel each."""
    rows = {}
    for op, (count, ms) in by_name.items():
        if BIAS_GRAD_KERNEL not in op:
            continue
        dname = "bfloat16" if "bfloat16" in op \
            else "float16" if "__half" in op else "float32"
        row = rows.setdefault(dname, {"launches": 0, "ms": 0.0})
        row["launches"] += count
        row["ms"] += ms
    launches = sum(row["launches"] for row in rows.values())
    if launches != calls:
        fail("%s: %d bias-gradient kernels on the device for %d calls"
             % (where, launches, calls))
    return {"calls": calls, "launches": launches,
            "ms": sum(row["ms"] for row in rows.values()), "by_dtype": rows}


def profile_epoch(torch):
    """One steady MNIST epoch on the card under torch.profiler: device
    busy time (union of kernel, copy and memset intervals) against the
    host wall time, and launches per step. The Chrome trace goes to
    chiprun_out/mnist_epoch_trace.json."""
    from torch.profiler import ProfilerActivity, profile
    from veles_torch.znicz.models import mnist
    wf = mnist.create_workflow(name="MnistProfile")
    wf.decision.max_epochs = None
    wf.initialize(device="cuda")
    wf.step.run_epoch()                  # uploads and first launches
    wf.loader.next_epoch()
    steps0 = wf.step.train_steps
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.step.run_epoch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_ops, by_name, path = device_trace(prof,
                                                 "mnist_epoch_trace.json")
    from veles_torch.znicz.ops.bias_grad import bias_grad
    bias = bias_grad_in_trace(by_name, bias_grad.launches, "mnist epoch")
    return {"phase": "profile", "wall_ms": wall_ms, "bias_grad": bias,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_ops else None,
            "device_ops": n_ops, "train_steps": wf.step.train_steps - steps0,
            "eval_steps": len(wf.loader.class_schedule(1)[0]),
            "top_device_ops": top_ops(by_name), "trace": path}


# -- flash attention ------------------------------------------------------


def flash_inputs(torch, shape, dtype, seed=1337):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(dtype) for _ in range(4))


def flash_reference(torch, q, k, v, dout, causal, out_in=None):
    """The float64 math from the same inputs, chunked over b·h: (out,
    lse), and with ``out_in`` also (dq, dk, dv), whose delta =
    rowsum(dout·out_in) as the kernels take it from the out they are
    given."""
    from veles_torch.znicz.ops import flash_attention as FA
    b, h, s, dh = q.shape
    scale = FA.scale_for(dh)
    flat = [t.reshape(b * h, s, dh) for t in (q, k, v, dout)]
    res = [torch.empty((b * h, s, dh), dtype=torch.float64, device="cuda")
           for _ in range(1 if out_in is None else 4)]
    lse = torch.empty((b * h, s), dtype=torch.float64, device="cuda")
    step = max(1, (1 << 27) // (s * s))
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda").triu(1)
    for i in range(0, b * h, step):
        sl = slice(i, min(i + step, b * h))
        qd, kd, vd, dod = (t[sl].double() for t in flat)
        sc = torch.matmul(qd, kd.transpose(1, 2)) * scale
        if causal:
            sc.masked_fill_(mask, float("-inf"))
        lse[sl] = torch.logsumexp(sc, dim=-1)
        p = torch.exp(sc - lse[sl][..., None])
        del sc
        res[0][sl] = torch.matmul(p, vd)
        if out_in is None:
            continue
        od = out_in.reshape(b * h, s, dh)[sl].double()
        ds = torch.matmul(dod, vd.transpose(1, 2))
        ds -= (dod * od).sum(dim=-1, keepdim=True)
        ds *= p * scale
        res[1][sl] = torch.matmul(ds, kd)
        res[2][sl] = torch.matmul(ds.transpose(1, 2), qd)
        res[3][sl] = torch.matmul(p.transpose(1, 2), dod)
        del p, ds
    return tuple(t.reshape(b, h, s, dh) for t in res[:1]) \
        + (lse.reshape(b, h, s),) \
        + tuple(t.reshape(b, h, s, dh) for t in res[1:])


def scaled_err(got, ref):
    """Worst element of (B, H, S, dh) ``got`` against ``ref``, each held
    to its own size and its row's: max of (|got − ref| − ATOL_SHARE ·
    max|ref|) / (|ref| + rms of ref's row)."""
    g, r = got.double(), ref.double()
    d = (g - r).abs() - ATOL_SHARE * r.abs().max()
    scale = r.abs() + r.square().mean(-1, keepdim=True).sqrt()
    return (d.clamp_min(0) / scale.clamp_min(1e-300)).max().item()


def check_flash(torch):
    """Phase flash_kernels; -> {kernel: max |kernel − plain|}."""
    from veles_torch.znicz.ops import flash_attention as FA
    worst = {name: 0.0 for name, _, _ in FLASH_KERNELS}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            tol = FLASH_TOL[dname]
            q, k, v, dout = flash_inputs(torch, shape, dtype)
            for causal in (True, False):
                row = {}
                ref_out, ref_lse = flash_reference(
                    torch, q, k, v, dout, causal)
                out_in = ref_out.to(dtype)
                lse_in = ref_lse.float()
                ref = flash_reference(torch, q, k, v, dout, causal, out_in)
                plain = {"fwd": FA.flash_attention_fwd_plain(q, k, v,
                                                             causal)}
                plain["fwd_pipe"] = plain["fwd"]
                plain["bwd"] = FA.flash_attention_bwd_plain(
                    q, k, v, out_in, lse_in, dout, causal)
                # the dq and dk/dv plain versions are bwd_plain's results
                # to the bit (tests/test_torch_flash_attention.py)
                plain["two"] = plain["bwd"]
                got = {}
                for variant, pipe in (("fwd", False), ("fwd_pipe", True)):
                    a = FA.flash_attention_fwd(q, k, v, causal, pipe)
                    b = FA.flash_attention_fwd(q, k, v, causal, pipe)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(a, b)):
                        fail("%s %s %s causal=%s: two launches differ"
                             % (variant, shape, dname, causal))
                    got[variant] = a
                a = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal)
                b = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail("bwd %s %s causal=%s: two launches differ"
                         % (shape, dname, causal))
                got["bwd"] = a
                a = FA.flash_attention_bwd(q, k, v, out_in, lse_in, dout,
                                           causal, fused=False)
                b = FA.flash_attention_bwd(
                    q, k, v, out_in, lse_in, dout, causal,
                    delta=FA.row_delta(out_in, dout), fused=False)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail("two-kernel bwd %s %s causal=%s: two launches, one "
                         "with delta hoisted, differ" % (shape, dname, causal))
                got["two"] = a
                acc = FA.flash_attention_fwd(q, k, v, causal,
                                             acc_dtype=torch.bfloat16)[0]
                acc_pipe = FA.flash_attention_fwd(
                    q, k, v, causal, True, torch.bfloat16)[0]
                checks = [("fwd", "out", got["fwd"][0], ref[0], tol),
                          ("fwd_pipe", "out", got["fwd_pipe"][0], ref[0],
                           tol),
                          ("fwd_acc_bf16", "out", acc, ref[0],
                           FLASH_ACC_BF16_TOL),
                          ("fwd_pipe_acc_bf16", "out", acc_pipe, ref[0],
                           FLASH_ACC_BF16_TOL),
                          ("plain_fwd", "out", plain["fwd"][0], ref[0],
                           tol)]
                near = FLASH_VS_PLAIN_TOL[dname]
                for i, name in enumerate(("dq", "dk", "dv")):
                    checks += [("bwd", name, got["bwd"][i], ref[2 + i], tol),
                               ("plain_bwd", name, plain["bwd"][i],
                                ref[2 + i], tol),
                               ("bwd_vs_plain", name, got["bwd"][i],
                                plain["bwd"][i], near),
                               ("two", name, got["two"][i], ref[2 + i], tol),
                               ("two_vs_plain", name, got["two"][i],
                                plain["two"][i], near),
                               ("two_vs_fused", name, got["two"][i],
                                got["bwd"][i], near)]
                for variant in ("fwd", "fwd_pipe"):
                    checks.append(("%s_vs_plain" % variant, "out",
                                   got[variant][0], plain[variant][0], near))
                over = []
                for label, name, g, r, t in checks:
                    e = scaled_err(g, r)
                    row["%s.%s" % (label, name)] = e
                    if not e <= t:
                        over.append("%s.%s scaled error %.3g over %.3g"
                                    % (label, name, e, t))
                for variant in ("fwd", "fwd_pipe", "plain_fwd"):
                    lse = (got.get(variant) or plain["fwd"])[1]
                    e = (lse.double() - ref[1]).abs().max().item()
                    row["%s.lse_abs" % variant] = e
                    if not e <= LSE_ATOL:
                        over.append("%s.lse error %.3g over %.3g"
                                    % (variant, e, LSE_ATOL))
                for name, variant, pairs in (
                        ("flash_fwd", "fwd", [(0, 0)]),
                        ("flash_fwd_pipe", "fwd_pipe", [(0, 0)]),
                        ("flash_bwd_fused", "bwd", [(0, 0), (1, 1),
                                                     (2, 2)]),
                        ("flash_bwd_dq", "two", [(0, 0)]),
                        ("flash_bwd_dkv", "two", [(1, 1), (2, 2)])):
                    for gi, pi in pairs:
                        worst[name] = max(worst[name], (
                            got[variant][gi].double()
                            - plain[variant][pi].double()).abs().max()
                            .item())
                emit({"phase": "flash_kernels", "shape": list(shape),
                      "dtype": dname, "causal": causal,
                      "bitwise_repeat": True,
                      # reported only (see check_two_kernel)
                      "two_dk_dv_bitwise_fused": all(
                          torch.equal(got["two"][i], got["bwd"][i])
                          for i in (1, 2)),
                      "scaled_err": row})
                if over:
                    fail("flash %s %s causal=%s: %s"
                         % (shape, dname, causal, "; ".join(over)))
                del ref, plain, got, a, b, acc, acc_pipe
            torch.cuda.empty_cache()
    return worst


def flash_bound_ms(shape, form):
    """Least time on an H100 for ``form`` of FLASH_WORK at the bf16 peak
    and the HBM rate: -> (ms, what bounds it)."""
    b, h, s, dh = shape
    products, tensors, rows = FLASH_WORK[form]
    ops = products * b * h * s * s * dh / 2
    nbytes = tensors * b * h * s * dh * 2 + rows * b * h * s * 4
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def time_flash(torch, timer):
    """Phase flash_kernel_times; -> {kernel: the main shape's row}."""
    import torch.nn.functional as F
    from veles_torch.znicz.ops import flash_attention as FA
    rows = {}
    for shape in FLASH_TIMED:
        reps = 25 if shape[2] <= 1024 else 5
        q, k, v, dout = flash_inputs(torch, shape, torch.bfloat16)
        out, lse = FA.flash_attention_fwd(q, k, v)
        delta = FA.row_delta(out, dout)
        grads = (q, k, v, out, lse, dout)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        plain_fwd = timer(lambda: FA.flash_attention_fwd_plain(q, k, v),
                          reps)
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps)
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), dout, retain_graph=True), reps)
        pair = functools.partial(FA.flash_attention_bwd, *grads,
                                 delta=delta, fused=False)
        # no one PyTorch call computes dq alone or dk/dv alone: their rows
        # have no library time; the pair's has SDPA's backward
        for name, fn, plain_fn, lib_ms, form in (
                ("flash_fwd", lambda: FA.flash_attention_fwd(q, k, v),
                 None, lib_fwd, "fwd"),
                ("flash_fwd_pipe",
                 lambda: FA.flash_attention_fwd(q, k, v, pipeline=True),
                 None, lib_fwd, "fwd"),
                ("flash_bwd_fused",
                 lambda: FA.flash_attention_bwd(*grads, delta=delta),
                 lambda: FA.flash_attention_bwd_plain(*grads, delta=delta),
                 lib_bwd, "bwd"),
                ("flash_bwd_dq",
                 lambda: FA.flash_attention_dq(*grads, delta=delta),
                 lambda: FA.flash_attention_dq_plain(*grads, delta=delta),
                 None, "dq"),
                ("flash_bwd_dkv",
                 lambda: FA.flash_attention_dkv(*grads, delta=delta),
                 lambda: FA.flash_attention_dkv_plain(*grads, delta=delta),
                 None, "dkv"),
                ("flash_bwd_pair", pair,
                 lambda: (FA.flash_attention_dq_plain(*grads, delta=delta),
                          FA.flash_attention_dkv_plain(*grads,
                                                       delta=delta)),
                 lib_bwd, "pair")):
            row = {"ms": timer(fn, reps),
                   "plain_ms": plain_fwd if plain_fn is None
                   else timer(plain_fn, reps),
                   "library_ms": lib_ms}
            row["bound_ms"], row["bound_by"] = flash_bound_ms(shape, form)
            emit({"phase": "flash_kernel_times", "kernel": name,
                  "shape": list(shape), "dtype": "bfloat16",
                  "causal": True, "reps": reps, **row})
            if shape == FLASH_MAIN:
                rows[name] = row
        fused = functools.partial(FA.flash_attention_bwd, *grads,
                                  delta=delta)
        turns = [("fused", timer(fused, reps)), ("pair", timer(pair, reps)),
                 ("pair", timer(pair, reps)), ("fused", timer(fused, reps))]
        emit({"phase": "flash_bwd_ab", "shape": list(shape),
              "dtype": "bfloat16", "causal": True, "reps": reps,
              "fused_ms": [t for form, t in turns if form == "fused"],
              "pair_ms": [t for form, t in turns if form == "pair"]})
        del q, k, v, dout, out, lse, delta, grads, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    return rows


# -- transformer LM -------------------------------------------------------


def reset_counts():
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.bias_grad import bias_grad
    FA.reset_launches()
    bias_grad.launches = 0
    bias_grad.form_launches = {"identity": 0, "masked": 0}


def read_counts():
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.bias_grad import bias_grad
    fwd = FA.flash_attention_fwd.variant_launches
    bwd = FA.flash_attention_bwd.variant_launches
    return {"flash_fwd": fwd["fwd"], "flash_fwd_pipe": fwd["fwd_pipe"],
            "flash_bwd_fused": bwd["fused"], "flash_bwd_dq": bwd["dq"],
            "flash_bwd_dkv": bwd["dkv"],
            "bias_grad[identity]": bias_grad.form_launches["identity"],
            "bias_grad[masked]": bias_grad.form_launches["masked"]}


def run_lm(torch, name, device, *overrides, valid_must_fall=True):
    """One LM run through the CLI entry point, its launches counted from
    0; -> (workflow, counts, summary dict). Fails on a wrong count, a
    non-finite parameter, or a train loss (and, with
    ``valid_must_fall``, a validation loss) that does not fall."""
    from veles_torch.__main__ import main as cli
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    reset_counts()
    wf = cli([LM_SAMPLE, "root.lm.model.attn_impl=pallas", *overrides,
              "--seed", "1337", "-d", device])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    layers = sum(isinstance(f, MultiHeadAttention) for f in wf.forwards)
    pipeline = wf.forwards[1].attn_pipeline
    train, evals = wf.step.train_steps, wf.step.eval_steps
    fwd = layers * (train + evals)
    want = {"flash_fwd": 0 if pipeline else fwd,
            "flash_fwd_pipe": fwd if pipeline else 0,
            "flash_bwd_fused": layers * train,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "bias_grad[identity]": train * (6 * layers + 1),
            "bias_grad[masked]": 0}
    if device == "cpu":
        want = dict(want, **{k: 0 for k in want})
    if counts != want:
        fail("lm %s: launches %s, expected %s" % (name, counts, want))
    for unit, sub in wf.export_tree().items():
        for key, t in sub.items():
            if not bool(torch.isfinite(t.float()).all()):
                fail("lm %s: %s.%s is not finite" % (name, unit, key))
    hist = wf.decision.history
    valid = [h["validation"]["loss"] for h in hist]
    train_loss = [h["train"]["loss"] for h in hist]
    if (valid_must_fall and not valid[-1] < valid[0]) \
            or not train_loss[-1] < train_loss[0]:
        fail("lm %s: loss did not fall: validation %s, train %s"
             % (name, valid, train_loss))
    per_epoch = (train + evals) / len(hist)
    tokens = (sum(wf.loader.class_lengths)
              * wf.loader.original_data.shape[1])
    summary = {"phase": "lm", "run": name, "device": device,
               "layers": layers, "train_steps": train, "eval_steps": evals,
               "launches": counts, "validation_loss": valid,
               "train_loss": train_loss,
               "epoch_seconds": wf.step.epoch_seconds}
    if len(hist) > 1:
        # the first epoch carries one-off costs (uploads, kernel load)
        warm = wf.step.epoch_seconds[1:]
        summary["tokens_per_sec"] = tokens * len(warm) / sum(warm)
        summary["ms_per_minibatch"] = 1e3 * sum(warm) / (
            per_epoch * len(warm))
    emit(summary)
    return wf, counts, summary


def lm_batch(torch, wf):
    """The first train minibatch of ``wf``'s loader on the card: (data,
    labels, valid count), as ``TorchStep.train_minibatch`` takes it."""
    from veles_torch.loader.base import CLASS_TRAIN
    full = wf.loader.device_full_arrays("cuda")
    idx_mat, valids = wf.loader.class_schedule(CLASS_TRAIN)
    idx = torch.as_tensor(idx_mat[0], dtype=torch.int64, device="cuda")
    return (torch.index_select(full["data"], 0, idx),
            torch.index_select(full["labels"], 0, idx),
            torch.tensor(int(valids[0]), device="cuda"))


def profile_lm_step(torch, wf):
    """One full-width train step of ``wf`` (already run on the card)
    under torch.profiler: device busy time and idle share, the top
    device operations and the flash kernels' share; plus the host-clock
    time of 5 train steps."""
    from torch.profiler import ProfilerActivity, profile
    batch = lm_batch(torch, wf)
    wf.step.train_minibatch(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        wf.step.train_minibatch(*batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 5
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.step.train_minibatch(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, n_ops, by_name, path = device_trace(prof, "lm_step_trace.json")
    flash_ms = sum(t for op, (_, t) in by_name.items()
                   if "flash_" in op or "dq_reduce" in op)
    from veles_torch.znicz.ops.bias_grad import bias_grad
    bias = bias_grad_in_trace(by_name, bias_grad.launches, "110M step")
    b, s = batch[0].shape
    return {"phase": "lm_profile", "shape": [b, s], "step_ms": step_ms,
            "tokens_per_sec": b * s / step_ms * 1e3, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if n_ops else None,
            "device_ops": n_ops, "flash_ms": flash_ms,
            "flash_share_of_busy": flash_ms / busy_ms if busy_ms else None,
            "bias_grad": bias,
            "bias_grad_share_of_busy": bias["ms"] / busy_ms if busy_ms
            else None,
            "top_device_ops": top_ops(by_name, 12), "trace": path}


def check_two_kernel(torch, wf):
    """Phase flash_bwd_two_kernel: the fused and the two-kernel backward
    on each attention unit's forward cache of ``wf`` (the 110M run), dout
    from a seeded generator, counted from 0; -> the counts."""
    from veles_torch.znicz.ops import flash_attention as FA
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    units = [f for f in wf.forwards if isinstance(f, MultiHeadAttention)]
    tol = FLASH_VS_PLAIN_TOL["bfloat16"]
    worst, bitwise, over = {}, 0, []
    reset_counts()
    for f in units:
        q, k, v, out, lse, _ = f.cache
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        fused = FA.flash_attention_bwd(q, k, v, out, lse, dout, f.causal)
        two = FA.flash_attention_bwd(q, k, v, out, lse, dout, f.causal,
                                     fused=False)
        for name, a, b in zip(("dq", "dk", "dv"), two, fused):
            e = scaled_err(a, b)
            worst[name] = max(worst.get(name, 0.0), e)
            if not e <= tol:
                over.append("%s %s scaled error %.3g over %.3g"
                            % (f.name, name, e, tol))
        # reported only: the bf16 fused kernel (wgmma) and the dk/dv
        # kernel (mma.sync) sum in different orders, so equal bits are
        # not expected
        bitwise += all(torch.equal(a, b) for a, b in zip(two[1:], fused[1:]))
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict({name: 0 for name in counts}, flash_bwd_fused=len(units),
                flash_bwd_dq=len(units), flash_bwd_dkv=len(units))
    emit({"phase": "flash_bwd_two_kernel", "units": len(units),
          "shape": list(q.shape), "dtype": str(q.dtype)[6:],
          "scaled_err_vs_fused": worst, "dk_dv_bitwise_fused": bitwise,
          "launches": counts})
    if over or counts != want:
        fail("two-kernel backward on the 110M activations: %s; launches "
             "%s, expected %s" % ("; ".join(over), counts, want))
    return counts


def check_lm(torch):
    """Phases lm, flash_bwd_two_kernel and lm_profile; -> launches of the
    flash kernels on their paths (the 110M run; the pipelined run for
    flash_fwd_pipe; the 110M activations for the two-kernel backward)."""
    _, _, cpu = run_lm(torch, "sample", "cpu")
    _, _, cuda = run_lm(torch, "sample", "cuda")
    gap = abs(cuda["validation_loss"][-1] - cpu["validation_loss"][-1])
    if gap > LM_CPU_TOLERANCE:
        fail("lm sample: final validation loss %.4f on cuda vs %.4f on cpu"
             % (cuda["validation_loss"][-1], cpu["validation_loss"][-1]))
    _, pipe, _ = run_lm(torch, "sample_pipeline", "cuda",
                        "root.lm.model.attn_pipeline=True")
    run_lm(torch, "sample_acc_bf16", "cuda", "root.lm.model.attn_acc=bf16")
    # 16 train steps on a 16384-token vocabulary: the train loss falls,
    # the validation loss need not yet
    wf, full, _ = run_lm(torch, "110M", "cuda", *LM_110M,
                         valid_must_fall=False)
    two = check_two_kernel(torch, wf)
    emit(profile_lm_step(torch, wf))
    return dict(full, flash_fwd_pipe=pipe["flash_fwd_pipe"],
                flash_bwd_dq=two["flash_bwd_dq"],
                flash_bwd_dkv=two["flash_bwd_dkv"])


def main(argv=None):
    import torch
    if (sys.argv[1:] if argv is None else argv):
        print("usage: chip_smoke.py (no arguments)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from veles_torch import kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    open(LOG_PATH, "w").close()

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build()
    for name, log in kernels.build_logs.items():
        with open(os.path.join(OUT_DIR, "nvcc_%s.log" % name), "w") as f:
            f.write(log)
    sass = {lib: sass_counts(kernels, lib) for lib in SM90_LIBRARIES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": built, "sources": kernels.sources(),
          "ptxas": {name: ptxas_report(log)
                    for name, log in kernels.build_logs.items()},
          "sass": sass})
    for lib, counts in sass.items():
        if counts is None:
            continue
        short = {fn: n for fn, n in counts.items()
                 if not all(n[op] for op in SM90_OPCODES)}
        if not counts or short:
            fail("%s: kernels without %s: %s" % (
                lib, " and ".join(SM90_OPCODES), short or counts))

    timer = Timer(torch)
    forms = check_kernels(torch, timer)
    flash_err = check_flash(torch)
    flash_rows = time_flash(torch, timer)
    launches = check_mnist_path(torch)
    lm_launches = check_lm(torch)

    emit({"kernels": [{
        "name": "bias_grad[%s]" % form,
        "route": "cuda",
        "source": "veles_torch/csrc/bias_grad.cu",
        "replaces": replaces,
        "launches": launches[form],
        "max_abs_err": forms[form]["max_abs_err"],
        "ms": forms[form]["kernel_ms"],
        "plain_ms": forms[form]["plain_ms"],
        "bound_ms": forms[form]["bound_ms"],
        "bound_by": forms[form]["bound_by"],
        "library_ms": forms[form]["library_ms"],
    } for form, _, _, replaces in FORMS] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": lm_launches[name],
        "max_abs_err": flash_err[name],
        **flash_rows[name],
    } for name, source, replaces in FLASH_KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def check_mnist_path(torch):
    """Phases mnist and profile; -> bias_grad launches by form on the
    MNIST path."""
    from veles_torch.znicz.ops.bias_grad import bias_grad
    cpu_wf = run_mnist(torch, "cpu")
    err_cpu = check_mnist(torch, cpu_wf, "cpu")
    reset_counts()
    wf = run_mnist(torch, "cuda")
    torch.cuda.synchronize()
    launches = dict(bias_grad.form_launches, total=bias_grad.launches)
    err_cuda = check_mnist(torch, wf, "cuda")
    steps = wf.step.train_steps
    if launches["total"] != 2 * steps or launches["identity"] != steps \
            or launches["masked"] != steps:
        fail("bias_grad launched %s times for %d train steps"
             % (launches, steps))
    if not err_cuda < 0.15 or abs(err_cuda - err_cpu) > 0.02:
        fail("final validation error %.4f on cuda vs %.4f on cpu"
             % (err_cuda, err_cpu))
    # the first epoch carries one-off costs (uploads, kernel load)
    per_epoch = steps / len(wf.step.epoch_seconds)
    warm = wf.step.epoch_seconds[1:]
    emit({"phase": "mnist", "train_steps": steps,
          "bias_grad_launches": launches,
          "train_steps_per_sec": per_epoch * len(warm) / sum(warm),
          "epoch_seconds": wf.step.epoch_seconds,
          "final_valid_error_cuda": err_cuda,
          "final_valid_error_cpu": err_cpu,
          "history_cuda": wf.decision.history})
    emit(profile_epoch(torch))
    return launches


if __name__ == "__main__":
    sys.exit(main())
