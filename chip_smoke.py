#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``veles_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing JSON lines; any failure ends the run non-zero:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compiles every kernel source in ``veles_torch/csrc`` with
   nvcc for sm_90a, all at once, and reports the seconds;
3. kernels — holds each kernel against its plain PyTorch version on the
   card: every activation, float32 and bfloat16 inputs, at the MNIST
   shapes and two large ones. The tolerance per column is
   ``1e-4·Σ_n|dz[n,k]|`` against the plain math in float64 (f32 sums
   taken in another order); two launches must agree bitwise. Times the
   kernel, its plain version and, for the identity form, the one
   PyTorch call that computes it, with the L2 cache flushed before
   every launch, beside the least time the card could take;
4. mnist   — trains the MNIST sample through the CLI entry point at its
   full width (784-100-10, minibatch 100, 6000/1000 samples), 3 epochs
   at seed 1337 on ``cuda`` and on ``cpu``. The bias-gradient kernel must
   have launched twice per train step (once per GD unit); the final
   validation error must be below 0.15 and within 0.02 of the CPU run;
5. profile — one more MNIST epoch under ``torch.profiler``: the
   device's busy time and idle share, launches per step, the top
   device operations (trace in ``chiprun_out/mnist_epoch_trace.json``);
6. the ``kernels`` summary line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ACTIVATIONS = ("linear", "softmax", "tanh", "relu", "strict_relu",
               "sigmoid")
SHAPES = ((100, 100), (100, 10), (72900, 96), (4097, 1000))
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def check_kernels(torch, timer):
    """Phase 3; -> {form: {"max_abs_err", and the main-path times}}."""
    from veles_torch.znicz.ops import activations as A
    from veles_torch.znicz.ops.bias_grad import bias_grad, bias_grad_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1337)
    forms = {form: {"max_abs_err": 0.0} for form, _, _, _ in FORMS}
    for n, k in SHAPES:
        base_err = torch.randn((n, k), generator=gen, device="cuda")
        base_y = torch.randn((n, k), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            err, y = base_err.to(dtype), base_y.to(dtype)
            worst = {}
            for act in ACTIVATIONS:
                out = bias_grad(err, y, act)
                again = bias_grad(err, y, act)
                torch.cuda.synchronize()
                if out.dtype != torch.float32 or out.shape != (k,):
                    fail("bias_grad %s %s: got %s %s"
                         % (act, (n, k), out.dtype, tuple(out.shape)))
                if not torch.equal(out, again):
                    fail("bias_grad %s %s %s: two launches differ"
                         % (act, (n, k), dtype))
                d = A.ACTIVATIONS[act][1](y.double())
                dz = err.double() if isinstance(d, float) \
                    else err.double() * d
                ref = dz.sum(dim=0)
                diff = (out.double() - ref).abs()
                limit = TOLERANCE * dz.abs().sum(dim=0)
                if not bool((diff <= limit).all()):
                    fail("bias_grad %s %s %s: error %.3g over limit "
                         "(worst ratio %.3g)" % (
                             act, (n, k), dtype, diff.max().item(),
                             (diff / limit.clamp_min(1e-30)).max().item()))
                form = "identity" if A.is_identity(act) else "masked"
                forms[form]["max_abs_err"] = max(
                    forms[form]["max_abs_err"], diff.max().item())
                worst[act] = diff.max().item()
            emit({"phase": "kernels", "shape": [n, k],
                  "dtype": str(dtype).replace("torch.", ""),
                  "max_abs_err": worst, "bitwise_repeat": True})
        # timings in the card's activation dtype
        err, y = base_err.to(torch.bfloat16), base_y.to(torch.bfloat16)
        for form, act, main_shape, _ in FORMS:
            row = {
                "kernel_ms": timer(lambda: bias_grad(err, y, act)),
                "plain_ms": timer(lambda: bias_grad_plain(err, y, act)),
                "library_ms": timer(
                    lambda: err.sum(0, dtype=torch.float32))
                if form == "identity" else None,
            }
            row["bound_ms"], row["bound_by"] = bound_ms(n, k, 2, act)
            emit({"phase": "kernel_times", "form": form,
                  "activation": act, "shape": [n, k], "dtype": "bfloat16",
                  **row})
            if (n, k) == main_shape:
                forms[form].update(row)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.step.run_epoch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mnist_epoch_trace.json")
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
    for lo, hi, name in spans:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + hi - lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    train = wf.step.train_steps - steps0
    return {"phase": "profile", "wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms
            if spans else None,
            "device_ops": len(spans), "train_steps": train,
            "eval_steps": len(wf.loader.class_schedule(1)[0]),
            "top_device_ops": [{"name": name[:80], "count": n,
                                "ms": t / 1e3} for name, (n, t) in top],
            "trace": os.path.relpath(path, HERE)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from veles_torch import kernels
    from veles_torch.znicz.ops.bias_grad import bias_grad

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": built, "sources": kernels.sources()})
    for name, log in kernels.build_logs.items():
        print("nvcc %s:\n%s" % (name, log), file=sys.stderr)

    forms = check_kernels(torch, Timer(torch))

    cpu_wf = run_mnist(torch, "cpu")
    err_cpu = check_mnist(torch, cpu_wf, "cpu")
    bias_grad.launches = 0
    bias_grad.form_launches = {"identity": 0, "masked": 0}
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
    } for form, _, _, replaces in FORMS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
