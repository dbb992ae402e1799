"""Convolution backward units of the port.

Counterpart of ``veles/znicz_tpu/ops/gd_conv.py``. From ``err_output``
(dL/d output, NHWC) a unit

1. multiplies by the activation derivative by output, ``dz = err ∘
   act'(y)``, in the flowing dtype, as the reference does;
2. takes ``err_input`` (the adjoint convolution, the input rows and
   columns the forward's stride never read receiving zero: the
   reference's stride remainders ``ry``/``rx``) and the weight gradient
   ``grad_w`` (the contraction over batch and output positions) from
   one cuDNN backward call, ``TorchDevice.conv2d_grads``: each the f32
   accumulation of the compute-dtype operands, as the reference's
   ``preferred_element_type=float32``;
3. takes the bias gradient through ``ops/bias_grad.bias_grad`` on the
   contiguous ``(B·oy·ox, K)`` views of ``err`` and ``y``: the
   hand-written kernel on the card, its plain version on the CPU (the
   reference's ``bias_grad_xla`` hatch to ``pallas_grads.bias_grad``);
4. applies the momentum update of ``GradientDescentBase``, with the
   weights from before this step's update used for ``err_input``.
"""

from veles_torch.znicz.nn_units import GradientDescentBase, gradient_for
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops.bias_grad import bias_grad
from veles_torch.znicz.ops.conv import (
    Conv, ConvTanh, ConvRELU, ConvStrictRELU, ConvSigmoid)


class GDConvBase(GradientDescentBase):
    ACTIVATION = "linear"

    def _deriv(self, err, y):
        d = A.ACTIVATIONS[self.ACTIVATION][1](y)
        return err if isinstance(d, float) else err * d

    def run(self, x, y, err):
        """Backward of the paired convolution for its input ``x`` and
        output ``y`` (NHWC) and ``err`` = dL/dy; updates the parameters
        and returns err_input (None when ``need_err_input`` is off)."""
        f = self.forward
        dev = f.device
        err = err.reshape(y.shape).contiguous()
        dz = self._deriv(err, y)
        xc, w, pad = f.conv_geometry(x)
        gx, gw = dev.conv2d_grads(dz.permute(0, 3, 1, 2), xc, w, f.sliding,
                                  pad, self.need_err_input)
        grad_w = gw.permute(0, 2, 3, 1).reshape(f.n_kernels, -1)
        err_input = None
        if self.need_err_input:
            ei = gx.permute(0, 2, 3, 1)
            if tuple(ei.shape) != tuple(x.shape):   # unequal padding
                top, _, left, _ = f.padding
                ei = ei[:, top:top + x.shape[1], left:left + x.shape[2], :]
            err_input = ei.to(dev.act_dtype).contiguous()
        grad_b = bias_grad(err.reshape(-1, f.n_kernels),
                           y.reshape(-1, f.n_kernels), self.ACTIVATION) \
            if f.include_bias else None
        self.update_weights(grad_w, grad_b)
        return err_input


@gradient_for(Conv)
class GradientDescentConv(GDConvBase):
    ACTIVATION = "linear"


@gradient_for(ConvTanh)
class GDTanhConv(GDConvBase):
    ACTIVATION = "tanh"


@gradient_for(ConvRELU)
class GDRELUConv(GDConvBase):
    ACTIVATION = "relu"


@gradient_for(ConvStrictRELU)
class GDStrictRELUConv(GDConvBase):
    ACTIVATION = "strict_relu"


@gradient_for(ConvSigmoid)
class GDSigmoidConv(GDConvBase):
    ACTIVATION = "sigmoid"
