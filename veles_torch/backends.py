"""The port's device: which card runs a workflow, and in which dtypes.

Counterpart of ``XLADevice`` in ``veles/backends.py``. The dtype policy
is the reference's with ``cuda`` in the TPU's place:

* ``compute_dtype`` — the dtype matmul inputs are cast to (bf16 on the
  card, f32 on the CPU); products accumulate and come back in f32;
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
        """``a @ b`` with inputs cast to ``compute_dtype``; the result is
        float32."""
        cd = self.compute_dtype
        return torch.matmul(a.to(cd), b.to(cd)).to(torch.float32)

    def __repr__(self):
        return "<TorchDevice %s compute=%s act=%s>" % (
            self.device, self.compute_dtype, self.act_dtype)


def get_device(spec=None) -> TorchDevice:
    """``TorchDevice`` from a CLI-ish spec; a ``TorchDevice`` is returned
    unchanged. The default is ``cuda``."""
    if isinstance(spec, TorchDevice):
        return spec
    return TorchDevice(spec)
