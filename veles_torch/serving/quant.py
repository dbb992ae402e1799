"""At-rest weight quantization for the serving planes of the port.

Counterpart of ``veles/serving/quant.py``: a matrix-shaped f32 weight is
held as a 1-byte payload plus a per-tensor scale (and, for int8, a zero
point), on whatever device the weight lives on, and is dequantized at
dispatch (``ArchiveModel.apply`` and the decode step densify each
unit's tree right before they use it), so the at-rest copy and the
device copy stay 1 byte per element.

* ``int8`` — the affine code of the gradient wire codec
  (``_int8_code``, kept here as the port's own copy): ``q·scale + zero``
  with ``zero = min(w)``, ``scale = (max − min)/255``, the range math in
  float64, ``q`` rounded half to even. Computed in float64 torch on the
  weight's device, which gives numpy's bits.
* ``fp8`` — ``torch.float8_e4m3fn`` (the H100 holds e4m3 natively) with
  the symmetric scale ``max|w|/448``, so every scaled value lies within
  the format's ±448.

Policy: only tensors with ``ndim >= 2`` and at least ``MIN_QUANT_SIZE``
elements quantize; biases and layernorm vectors stay f32.
"""

import numpy
import torch

#: accepted quantize values
MODES = ("none", "int8", "fp8")

#: smallest element count worth quantizing
MIN_QUANT_SIZE = 1024

#: float8_e4m3fn's largest finite value, the symmetric fp8 scale target
_FP8_MAX = 448.0


def _int8_code(a):
    """Per-tensor affine code of a tensor -> (uint8 payload, scale,
    zero) as Python floats (float64): ``zero = min``, ``scale = (max −
    min)/255`` (0 for a constant tensor, which then rides the zero point
    exactly), ``q = clip(rint((a − zero)/scale), 0, 255)``."""
    a = a.to(torch.float64)
    lo = float(a.min()) if a.numel() else 0.0
    hi = float(a.max()) if a.numel() else 0.0
    scale = (hi - lo) / 255.0
    if scale <= 0.0:
        return torch.zeros(a.shape, dtype=torch.uint8,
                           device=a.device), 0.0, lo
    q = torch.clamp(torch.round((a - lo) / scale), 0, 255)
    return q.to(torch.uint8), scale, lo


class QuantizedTensor:
    """One at-rest quantized weight: payload + per-tensor scale (and zero
    point for int8), the scalars as 0-d f32 tensors on the payload's
    device. :meth:`dense` reconstructs f32 at dispatch."""

    __slots__ = ("mode", "q", "scale", "zero")

    def __init__(self, mode, q, scale, zero):
        self.mode = mode
        self.q = q
        self.scale = scale
        self.zero = zero

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def device(self):
        return self.q.device

    @property
    def nbytes(self):
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * 4 + self.zero.numel() * 4)

    def to(self, device):
        """The same tensor with its payload and scalars on ``device``."""
        return QuantizedTensor(self.mode, self.q.to(device),
                               self.scale.to(device), self.zero.to(device))

    def dense(self, payload=None):
        """f32 reconstruction of ``payload`` (default the whole ``q``; a
        gathered or sliced piece of it takes the same per-tensor
        scale)."""
        q = self.q if payload is None else payload
        v = q.to(torch.float32) * self.scale
        return v + self.zero if self.mode == "int8" else v

    def __repr__(self):
        return ("QuantizedTensor(%s, shape=%s, %d bytes)"
                % (self.mode, self.shape, self.nbytes))


def _scalar(value, device):
    """A 0-d f32 tensor of ``value`` rounded to float32 (numpy's
    rounding)."""
    return torch.tensor(numpy.float32(value), device=device)


def quantize_tensor(arr, mode):
    """One f32 tensor -> :class:`QuantizedTensor` on its device. An
    already-quantized tensor in the same mode passes through; another
    mode densifies first."""
    if isinstance(arr, QuantizedTensor):
        if arr.mode == mode:
            return arr
        arr = arr.dense()
    a = torch.as_tensor(arr).to(torch.float32).contiguous()
    if mode == "int8":
        q, scale, zero = _int8_code(a)
        return QuantizedTensor("int8", q, _scalar(scale, a.device),
                               _scalar(zero, a.device))
    if mode == "fp8":
        amax = float(a.abs().max()) if a.numel() else 0.0
        scale = (amax / _FP8_MAX) if amax > 0 else 1.0
        s = _scalar(scale, a.device)
        q = (a / s).to(torch.float8_e4m3fn)
        return QuantizedTensor("fp8", q, s, _scalar(0.0, a.device))
    raise ValueError("unknown weight-quantization mode %r (known: %s)"
                     % (mode, ", ".join(MODES)))


def _eligible(arr):
    if isinstance(arr, QuantizedTensor):
        return True
    return (arr.dim() >= 2 and arr.numel() >= MIN_QUANT_SIZE
            and arr.is_floating_point())


def validate_mode(mode, param="quantize"):
    """Raise on anything outside :data:`MODES`."""
    if mode not in MODES:
        raise ValueError("%s must be one of %s, got %r"
                         % (param, "|".join(MODES), mode))


def quantize_tree(params, mode):
    """``{unit: {key: tensor}}`` -> a fresh tree with every eligible
    leaf quantized; ``mode='none'`` returns the input itself."""
    validate_mode(mode)
    if mode == "none":
        return params
    return {name: {key: (quantize_tensor(a, mode) if _eligible(a) else a)
                   for key, a in tree.items()}
            for name, tree in params.items()}


def dense_params(tree):
    """One unit's param dict with every quantized leaf reconstructed in
    f32 (the dispatch-time hook); the dict itself when nothing in it is
    quantized."""
    if not any(isinstance(v, QuantizedTensor) for v in tree.values()):
        return tree
    return {k: (v.dense() if isinstance(v, QuantizedTensor) else v)
            for k, v in tree.items()}


def gather_rows(leaf, idx):
    """``leaf[idx]`` in f32: a quantized leaf is indexed first and only
    the gathered rows dequantize (the embedding's consumer is a gather,
    so densifying the whole vocabulary table per step would undo the
    saving)."""
    if isinstance(leaf, QuantizedTensor):
        return leaf.dense(leaf.q[idx])
    return leaf[idx]


def tree_to(params, device):
    """The tree with every leaf (plain or quantized) on ``device``."""
    return {name: {k: v.to(device) for k, v in tree.items()}
            for name, tree in params.items()}


def tree_nbytes(params):
    """Summed leaf bytes of a (possibly quantized) params tree."""
    return sum(a.nbytes if isinstance(a, QuantizedTensor)
               else a.numel() * a.element_size()
               for tree in params.values() for a in tree.values())
