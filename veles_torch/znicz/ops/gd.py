"""Gradient-descent units for fully-connected layers, PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/gd.py``. Given ``err_output``
(dL/d output) a unit

1. multiplies by the activation derivative expressed via the forward
   output (``err ∘ act'(y)``) -> dL/dz;
2. emits ``err_input = dL/dz · Wᵀ`` (with the weights from before this
   step's update) for the preceding GD unit;
3. computes ``ΔW = xᵀ · dL/dz`` and ``Δb = Σ_rows err ∘ act'(y)`` — the
   latter through ``ops/bias_grad.bias_grad`` — and applies the momentum
   update of :class:`GradientDescentBase`.

``GDSoftmax`` is the fused softmax+cross-entropy backward: the evaluator
already emitted dL/dz, so the derivative is the identity.
"""

from veles_torch.znicz.nn_units import GradientDescentBase, gradient_for
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops.all2all import (
    All2All, All2AllTanh, All2AllRELU, All2AllStrictRELU,
    All2AllSigmoid, All2AllSoftmax,
)
from veles_torch.znicz.ops.bias_grad import bias_grad


class GDBase(GradientDescentBase):
    """Shared math for dense backward units."""

    def _deriv(self, err, y):
        d = A.ACTIVATIONS[self.ACTIVATION][1](y)
        if isinstance(d, float):  # linear / softmax pass-through
            return err
        return err * d

    def run(self, x, y, err):
        """Backward of the paired forward for its input ``x``, output
        ``y`` and ``err`` = dL/dy; updates the parameters and returns
        err_input (None when ``need_err_input`` is off)."""
        f = self.forward
        dev = f.device
        err = err.reshape(err.shape[0], -1)
        y2 = y.reshape(err.shape)
        dz = self._deriv(err, y2)
        w = f.weights
        x2 = x.reshape(x.shape[0], -1)
        err_input = None
        if self.need_err_input:
            ei = dev.dot(dz, w if f.weights_transposed else w.t())
            err_input = ei.reshape(x.shape).to(dev.act_dtype)
        grad_w = dev.dot(dz.t(), x2) if f.weights_transposed \
            else dev.dot(x2.t(), dz)
        grad_b = bias_grad(err, y2, self.ACTIVATION) \
            if f.include_bias else None
        self.update_weights(grad_w, grad_b)
        return err_input


@gradient_for(All2All)
class GradientDescent(GDBase):
    ACTIVATION = "linear"


@gradient_for(All2AllTanh)
class GDTanh(GDBase):
    ACTIVATION = "tanh"


@gradient_for(All2AllRELU)
class GDRELU(GDBase):
    ACTIVATION = "relu"


@gradient_for(All2AllStrictRELU)
class GDStrictRELU(GDBase):
    ACTIVATION = "strict_relu"


@gradient_for(All2AllSigmoid)
class GDSigmoid(GDBase):
    ACTIVATION = "sigmoid"


@gradient_for(All2AllSoftmax)
class GDSoftmax(GDBase):
    """Fused softmax+CE backward: err passes through."""
    ACTIVATION = "softmax"
