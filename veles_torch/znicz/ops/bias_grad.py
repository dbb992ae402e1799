"""The bias gradient ``Σ_n err[n, k]·act'(y[n, k])``, f32-accumulated.

Replaces the Pallas kernels of ``veles/znicz_tpu/ops/pallas_grads.py``:
``_bias_grad_kernel`` (the masked form) and ``_sum_rows_kernel`` (the
identity form of linear/softmax, which never reads ``y``), both reached
through ``bias_grad`` there. On the card the work goes to the
hand-written CUDA kernel ``veles_torch/csrc/bias_grad.cu``; on the CPU to
:func:`bias_grad_plain`, the plain PyTorch version of the same function.

What bounds it on an H100: bytes. It reads ``err`` and ``y`` once,
2·N·K·itemsize bytes (N·K·itemsize for the identity form), at 3.35 TB/s;
its arithmetic is a few f32 operations per element. The TPU kernel kept
its sum in an output block revisited over a sequential row grid. A GPU
grid is parallel, so the kernel splits the rows over CTAs and adds their
partial sums in the same launch: the CTA that takes a column tile's last
ticket adds the tile's partials in row-block order. Loads are 16 bytes a
thread where rows and pointers are 16-byte aligned (one element a thread
otherwise), several in flight per thread, on a grid of about four CTAs
per SM (:func:`plan`, the Python model of the launch). One launch per
call, no float atomics: the result is bitwise the same from run to run.
"""

import collections
import ctypes
import functools

import torch

from veles_torch import kernels
from veles_torch.znicz.ops import activations as A

#: activation name -> code of ``enum Act`` in csrc/bias_grad.cu
_ACT_CODES = {"linear": 0, "softmax": 0, "tanh": 1, "relu": 2,
              "strict_relu": 3, "sigmoid": 4}
#: dtype -> code of ``enum DType`` in csrc/bias_grad.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    "veles_bias_grad": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]),
    "veles_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: most threads of a CTA (``kThreads`` in csrc/bias_grad.cu)
THREADS = 256
#: loads each lane issues before its first add (``kUnroll``)
UNROLL = 4
#: lanes of one warp along K: 32 packs, 512 bytes of a bf16 row
WARP = 32
#: CTAs the planner aims for: four per SM of an H100's 132
TARGET_CTAS = 4 * 132
#: fewest rows a lane sums before another row block is worth it: two
#: rounds of UNROLL loads
MIN_ROWS_PER_LANE = 2 * UNROLL
#: most row blocks (``kMaxRowBlocks``): two CTAs per SM where K is one
#: column tile; the CTA that takes a column tile's last ticket adds this
#: many partials per column
MAX_ROW_BLOCKS = 2 * 132
#: bytes one vector load reads
PACK_BYTES = 16

Plan = collections.namedtuple(
    "Plan", "vec tx ty col_tiles row_blocks rows_per_block")
Plan.__doc__ = """Launch of csrc/bias_grad.cu for an (N, K) input: a grid of
``(col_tiles, row_blocks)`` CTAs of ``tx * ty`` threads; thread (tx, ty)
of CTA (c, b) owns the ``vec`` columns from ``(c * tx + tx) * vec`` and
sums rows ``b * rows_per_block + ty``, ``+ ty``, ... of its row block
(the last block may be short). ``vec`` > 1 is the 16-byte vector path.
With one row block the CTA writes the result; with several each writes a
partial row and takes one of ``col_tiles`` tickets."""


@functools.lru_cache(maxsize=1024)
def plan(n, k, itemsize=2, aligned=True):
    """The :class:`Plan` for an ``(n, k)`` input of ``itemsize``-byte
    elements whose base pointers are 16-byte aligned (``aligned``): the
    vector path where the row pitch is a multiple of PACK_BYTES too, TX
    all of K's packs up to one warp, and about TARGET_CTAS CTAs, each lane
    summing at least MIN_ROWS_PER_LANE rows, at most MAX_ROW_BLOCKS row
    blocks."""
    vec = PACK_BYTES // itemsize \
        if aligned and (k * itemsize) % PACK_BYTES == 0 else 1
    units = k // vec
    tx = min(units, WARP)
    ty = THREADS // tx
    col_tiles = -(-units // tx)
    row_blocks = max(1, min(-(-n // (ty * MIN_ROWS_PER_LANE)),
                            TARGET_CTAS // col_tiles, MAX_ROW_BLOCKS))
    rows_per_block = -(-n // row_blocks)
    return Plan(vec, tx, ty, col_tiles, -(-n // rows_per_block),
                rows_per_block)


def sum_order(p):
    """The order in which the CTA that takes a column tile's last ticket
    adds the tile's partials: ``[[row block, ...] per lane, ...]``, lane
    ``ty`` over row blocks ``ty, ty + TY, ...``, the lanes then added in
    order. Fixed by the plan alone, never by which CTA arrives when."""
    return [list(range(lane, p.row_blocks, p.ty)) for lane in range(p.ty)]


_tickets = {}


def tickets(device, stream, count):
    """The tickets of launches on ``stream``: ``count`` or more int32 zeros
    on ``device``, allocated once and kept. Every launch leaves them 0
    (the last CTA of a column tile resets its ticket), so no launch needs
    a memset; one buffer per stream, so launches on two streams never
    share a ticket."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def bias_grad_plain(err, y, activation):
    """The plain PyTorch version: ``(err ∘ act'(y)).sum(0)`` in f32."""
    d = A.ACTIVATIONS[activation][1](y.to(torch.float32))
    e = err.to(torch.float32)
    return (e if isinstance(d, float) else e * d).sum(dim=0)


def bias_grad(err, y, activation):
    """``Σ_n (err ∘ act'(y))[n, k]`` over 2-D ``(N, K)`` inputs -> (K,)
    float32. ``err`` and ``y`` may be float32, bfloat16 or float16; the
    derivative and the sum run in f32. A CUDA tensor goes to the kernel
    (or this raises); a CPU tensor to :func:`bias_grad_plain`."""
    if activation not in A.ACTIVATIONS:
        raise KeyError("unknown activation %r" % (activation,))
    if err.dim() != 2 or tuple(y.shape) != tuple(err.shape):
        raise ValueError("err %s and y %s must be equal 2-D shapes"
                         % (tuple(err.shape), tuple(y.shape)))
    if err.device.type == "cpu" and y.device.type == "cpu":
        return bias_grad_plain(err, y, activation)
    identity = A.is_identity(activation)
    if err.device.type != "cuda" or y.device != err.device:
        raise ValueError("err on %s and y on %s: the kernel needs both on "
                         "one CUDA device" % (err.device, y.device))
    if err.dtype not in _DTYPE_CODES:
        raise TypeError("bias_grad kernel takes %s, got %s"
                        % (sorted(map(str, _DTYPE_CODES)), err.dtype))
    if not identity and y.dtype != err.dtype:
        raise TypeError("err %s and y %s must share a dtype"
                        % (err.dtype, y.dtype))
    if not err.is_contiguous() or not (identity or y.is_contiguous()):
        raise ValueError("bias_grad kernel needs contiguous inputs")
    n, k = err.shape
    out = torch.empty(k, dtype=torch.float32, device=err.device)
    if n == 0 or k == 0:
        return out.zero_()
    p = plan(n, k, err.element_size(),
             err.data_ptr() % PACK_BYTES == 0
             and (identity or y.data_ptr() % PACK_BYTES == 0))
    stream = torch.cuda.current_stream(err.device).cuda_stream
    partials = ticket_buf = None
    if p.row_blocks > 1:
        partials = torch.empty((p.row_blocks, k), dtype=torch.float32,
                               device=err.device)
        ticket_buf = tickets(err.device, stream, p.col_tiles)
    lib = kernels.load("bias_grad", _SIGNATURES)
    rc = lib.veles_bias_grad(
        err.data_ptr(), None if identity else y.data_ptr(),
        None if partials is None else partials.data_ptr(), out.data_ptr(),
        None if ticket_buf is None else ticket_buf.data_ptr(), n, k,
        _DTYPE_CODES[err.dtype], _ACT_CODES[activation], p.vec, p.tx, p.ty,
        p.row_blocks, p.rows_per_block, stream)
    if rc:
        raise RuntimeError("bias_grad kernel launch failed: %s (%d)" % (
            lib.veles_cuda_error_string(rc).decode(), rc))
    bias_grad.launches += 1
    bias_grad.form_launches["identity" if identity else "masked"] += 1
    return out


#: kernel launches, in all and by form; reset by whoever reads them
bias_grad.launches = 0
bias_grad.form_launches = {"identity": 0, "masked": 0}
