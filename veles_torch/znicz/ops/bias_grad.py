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
grid is parallel, so the kernel runs two passes instead: pass 1 spreads
row chunks over enough blocks (about four per SM) to keep loads in flight
and writes f32 partial sums per chunk; pass 2 adds the chunks' partials
in a fixed order. No float atomics, so the result is bitwise the same
from run to run.
"""

import ctypes

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
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]),
    "veles_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: threads per block of pass 1 (``kThreads`` in csrc/bias_grad.cu)
THREADS = 256
#: pass-1 blocks the planner aims for: four per SM of an H100's 132
TARGET_BLOCKS = 4 * 132
#: fewest rows one thread of pass 1 sums before another block is worth it
MIN_ROWS_PER_THREAD = 8


def _pow2_ceil(n):
    b = 1
    while b < n:
        b *= 2
    return b


def plan(n, k):
    """Launch shape of pass 1 for an ``(n, k)`` input: ``(bx,
    row_blocks, rows_per_block)``. ``bx`` threads run along K and
    ``THREADS // bx`` lanes over rows; ``row_blocks`` chunks of
    ``rows_per_block`` rows cover all ``n`` rows (the last chunk may be
    short). One chunk means pass 1 writes the result itself."""
    bx = min(THREADS, max(8, _pow2_ceil(k)))
    lanes = THREADS // bx
    col_tiles = -(-k // bx)
    row_blocks = min(-(-n // (lanes * MIN_ROWS_PER_THREAD)),
                     max(1, TARGET_BLOCKS // col_tiles), 65535)
    rows_per_block = -(-n // max(row_blocks, 1))
    row_blocks = -(-n // rows_per_block)
    return bx, row_blocks, rows_per_block


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
    bx, row_blocks, rows_per_block = plan(n, k)
    partials = torch.empty((row_blocks, k) if row_blocks > 1 else (0,),
                           dtype=torch.float32, device=err.device)
    lib = kernels.load("bias_grad", _SIGNATURES)
    stream = torch.cuda.current_stream(err.device).cuda_stream
    rc = lib.veles_bias_grad(
        err.data_ptr(), None if identity else y.data_ptr(),
        partials.data_ptr() if row_blocks > 1 else None, out.data_ptr(),
        n, k, _DTYPE_CODES[err.dtype], _ACT_CODES[activation], bx,
        row_blocks, rows_per_block, stream)
    if rc:
        raise RuntimeError("bias_grad kernel launch failed: %s (%d)" % (
            lib.veles_cuda_error_string(rc).decode(), rc))
    bias_grad.launches += 1
    bias_grad.form_launches["identity" if identity else "masked"] += 1
    return out


#: kernel launches, in all and by form; reset by whoever reads them
bias_grad.launches = 0
bias_grad.form_launches = {"identity": 0, "masked": 0}
