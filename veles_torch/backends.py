"""The port's device: which card runs a workflow, and in which dtypes.

Counterpart of ``XLADevice`` in ``veles/backends.py``. The dtype policy
is the reference's with ``cuda`` in the TPU's place:

* ``compute_dtype`` — the dtype matmul inputs are cast to (bf16 on the
  card, f32 on the CPU); products accumulate in f32 and come back as
  that f32 sum, never rounded to the input dtype (the reference's
  ``preferred_element_type=float32``, ``veles/accelerated_units.py``);
* ``act_dtype`` — the dtype of tensors flowing between units (outputs,
  error flows): bf16 on the card, f32 on the CPU;

both overridable by ``root.common.engine.compute_dtype`` /
``root.common.engine.amp``. Parameters and solver state stay f32.

TF32 is off for both float32 matmuls and cuDNN convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False and stated in
``allow_tf32``), so a float32 product means float32 on every device.

A device is asked for by name. ``cuda`` on a host without a card raises:
nothing falls back to the CPU on its own.
"""

import torch

from veles_torch.config import root

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class TorchDevice:
    """A ``torch.device`` plus the dtype policy units compute under."""

    def __init__(self, spec="cuda"):
        spec = str(spec or "cuda")
        if spec != "cpu" and spec.split(":")[0] != "cuda":
            raise ValueError("device must be 'cuda', 'cuda:N' or 'cpu', "
                             "got %r" % spec)
        if spec != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch sees no CUDA device; "
                "pass -d cpu / device='cpu' to run on the CPU" % spec)
        self.device = torch.device(spec)
        self.platform = self.device.type
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.allow_tf32 = False
        self.compute_dtype = self._policy(
            "compute_dtype", ("float32", "bfloat16", "float16"))
        self.act_dtype = self._policy("amp", ("float32", "bfloat16"))

    def _policy(self, key, allowed):
        name = root.common.engine.get(key)
        if name:
            if name not in allowed:
                raise ValueError("root.common.engine.%s must be one of %s, "
                                 "got %r" % (key, allowed, name))
            return _DTYPES[name]
        return torch.bfloat16 if self.platform == "cuda" else torch.float32

    def dot(self, a, b):
        """``a @ b`` of the inputs rounded to ``compute_dtype``: the f32
        accumulation, unrounded. On the card a bf16/f16 product runs as
        one GEMM with an f32 output (:func:`f32_matmul`); on the CPU the
        rounded inputs are multiplied in f32."""
        cd = self.compute_dtype
        a, b = a.to(cd), b.to(cd)
        if cd == torch.float32:
            return torch.matmul(a, b)
        if self.platform == "cuda":
            return f32_matmul(a, b)
        return torch.matmul(a.float(), b.float())

    def __repr__(self):
        return "<TorchDevice %s compute=%s act=%s>" % (
            self.device, self.compute_dtype, self.act_dtype)


def f32_matmul(a, b):
    """``a @ b`` of two bf16/f16 CUDA tensors as the GEMM's f32 output
    (``torch.mm`` / ``torch.bmm`` with ``out_dtype``): ``(..., M, K) @
    (K, N)`` on a 2-D view of ``a``'s rows, ``(..., M, K) @ (..., K, N)``
    with equal leading dims as one batched product. Strided operands
    (``w.t()``) go to the GEMM as they are. A torch without these
    overloads raises; nothing rounds the product to the input dtype."""
    out = torch.float32
    if b.dim() == 2:
        rows = a.reshape(-1, a.shape[-1])
        return torch.mm(rows, b, out_dtype=out).reshape(
            *a.shape[:-1], b.shape[-1])
    if a.dim() == b.dim() >= 3 and a.shape[:-2] == b.shape[:-2]:
        lead = a.shape[:-2]
        c = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                      b.reshape(-1, *b.shape[-2:]), out_dtype=out)
        return c.reshape(*lead, *c.shape[-2:])
    raise ValueError("f32_matmul takes (..., M, K) @ (K, N) or equal "
                     "leading dims, got %s @ %s"
                     % (tuple(a.shape), tuple(b.shape)))


def get_device(spec=None) -> TorchDevice:
    """``TorchDevice`` from a CLI-ish spec; a ``TorchDevice`` is returned
    unchanged. The default is ``cuda``."""
    if isinstance(spec, TorchDevice):
        return spec
    return TorchDevice(spec)
