"""Per-step performance accounting of the port: the counterpart of
``veles/perf.py``.

The reference derives a compiled program's FLOPs and bytes from its
jaxpr without running it. The port's steps are eager PyTorch with
hand-written kernels launched through ``ctypes``, so there is nothing to
trace: :class:`CostCounter` observes one REAL dispatch instead, as a
``TorchDispatchMode`` of its own, under these rules:

* ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (and ``_int_mm``,
  ``_scaled_mm``) count ``2·|out|·K`` multiply-add flops exactly, and
  ``convolution`` and ``convolution_backward`` ``2·|out|·(kernel
  footprint per output element)``, as the reference's ``_dot_flops`` and
  ``_conv_flops`` do (the input gradient of a strided convolution counts
  its dilated zeros, as the reference's lhs-dilated convolution does);
* every other operation counts one flop per output element, and every
  operation's bytes are its outputs' bytes (an in-place operation's
  output once: the tensor it wrote);
* views and metadata operations count nothing: a view, ``empty*``,
  ``detach``, ``alias``, ``item()`` and a copy to the host (the step's
  one metrics copy is not work of the step);
* the hand-written kernels are invisible to the dispatcher, so each
  entry point (``flash_attention_fwd``/``_bwd``/``_dq``/``_dkv``,
  ``bias_grad``) reports the work its kernel does through
  :func:`add_kernel_cost` when a counter is active on the thread: the
  causal half of the flash block products, the bias gradient's f32
  operations per element. Their plain versions are ordinary torch
  operations, which the counter sees unaided.

``io_bytes`` is the bytes of every storage the dispatch read that
existed before it (parameters, solver state, the device-resident
dataset): a size proxy for what a costed signature pins, as the
reference's program I/O footprint is.

:class:`PerfLedger` caches one :class:`StepCost` per key and publishes
the ``veles_step_*`` families on every dispatch (``znicz/step.py``):
``veles_step_flops_total{kind}``, ``veles_step_bytes_total{kind}``,
``veles_step_flops_per_second{kind}``, ``veles_step_mfu_ratio{kind}``
(when the device peak is known, :func:`device_peak_flops`),
``veles_step_samples_per_second{kind}`` and
``veles_step_tokens_per_second{kind}``. ``kind`` is the port's dispatch
kind, the loader class (``train``, ``valid``, ``test``), not the
reference's ``epoch``/``stream``/``window``. Accounting never breaks a
dispatch: a counter failure degrades to a zero :class:`StepCost`; an
error of the dispatch itself (a kernel's) is not caught.
"""

import os
import threading
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from veles_torch import telemetry


class StepCost:
    """Cost of ONE call of a costed dispatch. ``precision`` is its
    dominant matmul input class by dot-FLOPs share ("bf16", "tf32",
    "f32", "int8" or "fp8"), so the MFU gauge scores it against the peak
    those matmuls have. ``dot_flops`` is the matmul, convolution and
    flash-block share of ``flops``; ``kernel_flops`` what each
    hand-written kernel reported, by name."""

    __slots__ = ("flops", "bytes", "io_bytes", "precision", "dot_flops",
                 "kernel_flops")

    def __init__(self, flops=0.0, bytes=0.0, io_bytes=0.0,
                 precision="bf16", dot_flops=0.0, kernel_flops=None):
        self.flops = float(flops)
        self.bytes = float(bytes)
        self.io_bytes = float(io_bytes)
        self.precision = precision
        self.dot_flops = float(dot_flops)
        self.kernel_flops = dict(kernel_flops or {})

    def __add__(self, other):
        """The cost of both calls: sums, the larger dot share's
        precision and the larger I/O footprint (the same state read)."""
        kernels = dict(self.kernel_flops)
        for name, f in other.kernel_flops.items():
            kernels[name] = kernels.get(name, 0.0) + f
        precision = self.precision if self.dot_flops >= other.dot_flops \
            else other.precision
        return StepCost(self.flops + other.flops, self.bytes + other.bytes,
                        max(self.io_bytes, other.io_bytes), precision,
                        self.dot_flops + other.dot_flops, kernels)

    def __repr__(self):
        return ("StepCost(flops=%.4g, bytes=%.4g, io_bytes=%.4g, "
                "precision=%s)" % (self.flops, self.bytes,
                                   self.io_bytes, self.precision))


# -- the counter ----------------------------------------------------------

#: matmul aten ops: (index of lhs, index of rhs) in their arguments
_DOT_OPS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2),
            "baddbmm": (1, 2), "_int_mm": (0, 1), "_scaled_mm": (0, 1)}
#: operations that move or describe no data (those returning no tensor,
#: sizes and flags, count nothing anyway)
_FREE_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "_unsafe_view", "set_", "resize_"))
#: of those, the ones whose output is fresh storage of the dispatch
_FACTORY_OPS = frozenset(("empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided"))

_local = threading.local()


def _tensors(values):
    """The tensors in ``values`` and in its lists/tuples (one level: the
    ``_foreach_*`` operations take lists)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _size(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def dot_class(a, b, tf32=False):
    """Precision class of one product by BOTH input dtypes: an 8-bit class
    only when both operands share it (a mixed product upcasts and runs the
    wide rate); bf16/f16 -> "bf16"; any f32 operand -> "tf32" when the
    backend allows TF32 for it, else "f32"."""
    def cls(dtype):
        if dtype in (torch.int8, torch.uint8):
            return "int8"
        if dtype.is_floating_point and dtype.itemsize == 1:
            return "fp8"
        if dtype in (torch.bfloat16, torch.float16):
            return "bf16"
        return "f32"
    ca, cb = cls(a), cls(b)
    if ca == cb and ca != "f32":
        return ca
    if "f32" in (ca, cb):
        return "tf32" if tf32 else "f32"
    return "bf16"


def _conv_flops(args, outs, backward):
    """2·|out|·(footprint per output element) of ``convolution`` or each
    output of ``convolution_backward``."""
    weight = args[2] if backward else args[1]
    transposed = bool(args[7] if backward else args[6])
    groups = int(args[9] if backward else args[8])
    taps = _size(weight.shape[2:])
    # forward footprint: input channels per group x taps (a transposed
    # weight is (C_in, C_out/g, ...), a plain one (C_out, C_in/g, ...))
    c_in = weight.shape[0] // groups if transposed else weight.shape[1]
    c_out = weight.shape[1] if transposed else weight.shape[0] // groups
    if not backward:
        return 2.0 * outs[0].numel() * c_in * taps
    grad_out = args[0]
    flops = 0.0
    mask = args[10]
    grads = iter(outs)
    if mask[0]:
        flops += 2.0 * next(grads).numel() * c_out * taps
    if mask[1]:
        # the weight gradient: every weight element sums over the batch
        # and the output positions
        per = grad_out.shape[0] * _size(grad_out.shape[2:])
        flops += 2.0 * next(grads).numel() * per
    return flops


class CostCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten operation dispatched on
    this thread while it is entered (the rules of the module docstring),
    plus what hand-written kernels report (:func:`add_kernel_cost`). Each
    operation runs exactly as it would without the counter; the counter
    only reads shapes, dtypes and storage addresses. ``failed`` holds the
    first accounting error, after which it counts nothing more and
    :meth:`cost` is a zero :class:`StepCost`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.dot_flops = 0.0
        self.dot_prec = {}
        self.kernel_flops = {}
        self.failed = None
        self._produced = set()
        self._read = {}

    def __enter__(self):
        stack = _local.__dict__.setdefault("counters", [])
        super().__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.counters.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.failed is None:
            try:
                self._account(func, args, out)
            except Exception as exc:
                self.failed = exc
        return out

    def _account(self, func, args, out):
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE_OPS:
            if name in _FACTORY_OPS:
                self._produced.add(out.untyped_storage().data_ptr())
            return
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:
            # an in-place operation that returns nothing (_foreach_*_):
            # its output is what it wrote
            outs = _tensors(a for a, spec in zip(args, func._schema.arguments)
                            if spec.alias_info is not None
                            and spec.alias_info.is_write)
        ins = _tensors(args)
        if any(t.device.type == "cpu" for t in outs) \
                and any(t.device.type != "cpu" for t in ins):
            return                       # a copy to the host
        for t in ins:
            ptr = t.untyped_storage().data_ptr()
            if ptr not in self._produced and ptr not in self._read:
                self._read[ptr] = t.untyped_storage().nbytes()
        seen = set()
        flops = nbytes = 0
        for t in outs:
            if id(t) in seen:
                continue
            seen.add(id(t))
            flops += t.numel()
            nbytes += t.numel() * t.element_size()
            self._produced.add(t.untyped_storage().data_ptr())
        if name in _DOT_OPS:
            i, j = _DOT_OPS[name]
            a, b = args[i], args[j]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
            self._dot(flops, dot_class(
                a.dtype, b.dtype, torch.backends.cuda.matmul.allow_tf32))
        elif name in ("convolution", "convolution_backward"):
            backward = name == "convolution_backward"
            flops = _conv_flops(args, outs, backward)
            x, w = args[1:3] if backward else args[:2]
            self._dot(flops, dot_class(x.dtype, w.dtype,
                                       torch.backends.cudnn.allow_tf32))
        self.flops += flops
        self.bytes += nbytes

    def _dot(self, flops, precision):
        self.dot_flops += flops
        self.dot_prec[precision] = self.dot_prec.get(precision, 0.0) + flops

    def add_kernel(self, name, flops, nbytes, precision=None):
        """Account one hand-written kernel's launch: ``flops`` of work
        (matmul-class work in ``precision`` when given) and ``nbytes``
        written."""
        if self.failed is not None:
            return
        self.flops += flops
        self.bytes += nbytes
        self.kernel_flops[name] = self.kernel_flops.get(name, 0.0) + flops
        if precision is not None:
            self._dot(flops, precision)

    def cost(self):
        """-> the :class:`StepCost` counted so far (zero after a
        failure)."""
        if self.failed is not None:
            return StepCost()
        precision = max(self.dot_prec, key=self.dot_prec.get) \
            if self.dot_prec else "bf16"
        return StepCost(self.flops, self.bytes, sum(self._read.values()),
                        precision, self.dot_flops, self.kernel_flops)


def active_counter():
    """The innermost :class:`CostCounter` entered on this thread, or
    None."""
    stack = _local.__dict__.get("counters")
    return stack[-1] if stack else None


def add_kernel_cost(name, flops, nbytes, precision=None):
    """A hand-written kernel's entry point reports its launch's work to the
    active counter, if any (:meth:`CostCounter.add_kernel`)."""
    counter = active_counter()
    if counter is not None:
        counter.add_kernel(name, flops, nbytes, precision)


# -- device peak ----------------------------------------------------------

#: dense peak FLOP/s per card by precision class and a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's H100 SXM datasheet, without
#: sparsity; MFU is relative to THIS). An f32 program is scored against
#: the TF32 rate when TF32 is allowed for its products, else against the
#: f32 rate outside the tensor cores, never against the bf16 peak.
_PEAK_FLOPS_BY_KIND = {
    "bf16": (("H100 80GB HBM3", 989.4e12), ("H100 SXM", 989.4e12)),
    "fp8": (("H100 80GB HBM3", 1978.9e12), ("H100 SXM", 1978.9e12)),
    "int8": (("H100 80GB HBM3", 1978.9e12), ("H100 SXM", 1978.9e12)),
    "tf32": (("H100 80GB HBM3", 494.7e12), ("H100 SXM", 494.7e12)),
    "f32": (("H100 80GB HBM3", 66.9e12), ("H100 SXM", 66.9e12)),
}

#: per-precision env overrides (the escape hatch for other hardware and
#: deterministic tests); VELES_PEAK_FLOPS is the default peak, the one
#: every class without an override of its own takes
_PEAK_ENV = {"bf16": "VELES_PEAK_FLOPS",
             "int8": "VELES_PEAK_FLOPS_INT8",
             "fp8": "VELES_PEAK_FLOPS_FP8"}


def _device_name(device=None):
    """The CUDA card's name for ``device`` (a torch device or spec; None:
    the current card, only once CUDA is initialized), else None."""
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = torch.cuda.current_device()
    else:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    try:
        return torch.cuda.get_device_name(device)
    except (RuntimeError, AssertionError):
        return None


def device_peak_flops(precision="bf16", device=None):
    """Peak FLOP/s of ``device`` (default: the current CUDA card once CUDA
    is initialized) for ``precision``, or None when unknown (the CPU, a
    card not in the table). ``$VELES_PEAK_FLOPS`` (and ``_INT8``/``_FP8``)
    override. A precision with no table entry for the card falls back to
    its bf16 row."""
    env = os.environ.get(_PEAK_ENV.get(precision, "VELES_PEAK_FLOPS"))
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    name = _device_name(device)
    if name is None:
        return None
    for table in (_PEAK_FLOPS_BY_KIND.get(precision, ()),
                  _PEAK_FLOPS_BY_KIND["bf16"]):
        for sub, peak in table:
            if sub in name:
                return peak
    return None


# -- the ledger -----------------------------------------------------------


class PerfLedger:
    """Per-signature cost cache + the ``veles_step_*`` publisher.

    :meth:`cost` counts a dispatch once per key; :meth:`record_dispatch`
    turns (cost, wall seconds, work counts) into registry updates. Both
    are cheap after the first call per key: a dict lookup, then a handful
    of counter operations per dispatch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._costs = {}
        self._kids = {}

    def cost(self, key, fn, args, owner=None):
        """Run ``fn(*args)``; -> (its result, the cached :class:`StepCost`
        for ``key``). On first sight of ``key`` the call runs under a
        :class:`CostCounter`, computing exactly what it computes without
        one; later calls run plainly. Counter failures degrade to a zero
        cost; an exception of ``fn`` propagates.

        Each entry holds a weakref to its ``owner`` (default ``fn``):
        callers key by ``id(owner)``, so an owner reallocated at a freed id
        must be counted again, not inherit the dead one's cost, and dead
        entries are dropped instead of accumulating forever."""
        owner = fn if owner is None else owner
        with self._lock:
            entry = self._costs.get(key)
            if entry is not None:
                ref, cost = entry
                if ref is None or ref() is owner:
                    return fn(*args), cost
                del self._costs[key]      # id reused by a new owner
        t0 = time.perf_counter()
        try:
            counter = CostCounter().__enter__()
        except Exception:
            counter = None
        try:
            out = fn(*args)
        finally:
            if counter is not None:
                try:
                    counter.__exit__(None, None, None)
                except Exception as exc:
                    counter.failed = exc
        cost = counter.cost() if counter is not None else StepCost()
        if telemetry.tracer.active:
            telemetry.tracer.add_complete(
                "perf.analyze", t0, time.perf_counter() - t0,
                flops=cost.flops)
        try:
            ref = weakref.ref(owner)
        except TypeError:
            ref = None                    # plain-callable fallback
        with self._lock:
            dead = [k for k, (r, _) in self._costs.items()
                    if r is not None and r() is None]
            for k in dead:
                del self._costs[k]
            self._costs[key] = (ref, cost)
        return out, cost

    def sizes(self):
        """Memory-accounting view (``profiling.py`` exports it as the
        ``veles_perf_ledger_*`` gauges): live costed signatures and their
        summed I/O footprint estimate (a size proxy for the state they
        read, not an allocator meter)."""
        with self._lock:
            entries = list(self._costs.values())
        programs, est = 0, 0.0
        for ref, cost in entries:
            if ref is not None and ref() is None:
                continue                 # owner died; sweep pending
            programs += 1
            est += cost.io_bytes
        return {"programs": programs, "est_bytes": est}

    def _children(self, kind):
        with self._lock:
            kids = self._kids.get(kind)
            if kids is None:
                kids = self._kids[kind] = {
                    "flops": telemetry.LazyChild(
                        lambda k=kind: telemetry.counter(
                            "veles_step_flops_total",
                            "Arithmetic performed by compiled step "
                            "programs (jaxpr-derived)",
                            ("kind",)).labels(k)),
                    "bytes": telemetry.LazyChild(
                        lambda k=kind: telemetry.counter(
                            "veles_step_bytes_total",
                            "Equation-output bytes of compiled step "
                            "programs (memory-traffic proxy)",
                            ("kind",)).labels(k)),
                    "fps": telemetry.LazyChild(
                        lambda k=kind: telemetry.gauge(
                            "veles_step_flops_per_second",
                            "Achieved FLOP/s of the latest dispatch",
                            ("kind",)).labels(k)),
                    "mfu": telemetry.LazyChild(
                        lambda k=kind: telemetry.gauge(
                            "veles_step_mfu_ratio",
                            "Achieved FLOP/s over the device peak "
                            "(VELES_PEAK_FLOPS overrides the table)",
                            ("kind",)).labels(k)),
                    "sps": telemetry.LazyChild(
                        lambda k=kind: telemetry.gauge(
                            "veles_step_samples_per_second",
                            "Samples consumed per second by the "
                            "latest dispatch", ("kind",)).labels(k)),
                    "tps": telemetry.LazyChild(
                        lambda k=kind: telemetry.gauge(
                            "veles_step_tokens_per_second",
                            "Tokens consumed per second by the "
                            "latest dispatch (LM loaders)",
                            ("kind",)).labels(k)),
                }
        return kids

    def record_dispatch(self, kind, cost, seconds, samples=None,
                        tokens=None, device=None):
        """Account one completed dispatch costing ``cost`` in all, that
        took ``seconds`` wall time on ``device`` (the MFU's peak; default:
        the current card) and consumed ``samples``/``tokens`` of data."""
        kids = self._children(kind)
        if cost is not None and cost.flops:
            kids["flops"].get().inc(cost.flops)
            if seconds > 0:
                fps = cost.flops / seconds
                kids["fps"].get().set(fps)
                peak = device_peak_flops(
                    getattr(cost, "precision", None) or "bf16", device)
                if peak:
                    kids["mfu"].get().set(fps / peak)
        if cost is not None and cost.bytes:
            kids["bytes"].get().inc(cost.bytes)
        if seconds > 0:
            if samples:
                kids["sps"].get().set(samples / seconds)
            if tokens:
                kids["tps"].get().set(tokens / seconds)


#: process-wide ledger (one spine, views on top)
ledger = PerfLedger()
