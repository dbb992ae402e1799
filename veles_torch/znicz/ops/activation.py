"""Standalone activation unit pairs of the port.

Counterpart of ``veles/znicz_tpu/ops/activation.py``: activation-only
Forward/Backward pairs, registered under the reference's names —
``activation_tanh``, ``activation_relu`` (soft), ``activation_str``
(strict relu), ``activation_sigmoid``, ``activation_log``
(``log(x + sqrt(x² + 1))``), ``activation_mul`` (identity),
``activation_tanhlog`` (the scaled tanh up to ``|x| = 15/9``, then
``sign(x)·(log(|x|·9/15) + 1.7159)``) and ``activation_sincos`` (sin on
even channels of the last axis, cos on odd ones). The forward computes in
its input's dtype and returns the activation dtype; the backward
multiplies the error by the derivative, by output where the port's
formula table (``activations.py``) has one, by input for the other four.
The units have no parameters: the backward only transforms the error.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, RoutingGradientBase, forward_unit, gradient_for)
from veles_torch.znicz.ops import activations as A


class ActivationForward(Forward):
    """y = f(x), shape-preserving, no weights."""

    PARAMS = ()
    #: (forward(x), derivative(x, y))
    FUNC = (None, None)

    def __init__(self, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)

    def initialize(self, input_shape, device):
        self.device = device
        return tuple(input_shape)

    def forward(self, x):
        return type(self).FUNC[0](x).to(self.device.act_dtype)


class ActivationBackward(RoutingGradientBase):
    """err_input = err · f'(x, y)."""

    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        err = err.reshape(y.shape)
        return (err * type(f).FUNC[1](x, y)).to(f.device.act_dtype)


def _pair(name, fwd, deriv):
    """Register an activation Forward/Backward unit pair."""
    suffix = name.split("_")[-1]
    fwd_cls = forward_unit(name)(type(
        "ActivationForward_%s" % suffix, (ActivationForward,),
        {"FUNC": (staticmethod(fwd), staticmethod(deriv))}))
    bwd_cls = gradient_for(fwd_cls)(type(
        "ActivationBackward_%s" % suffix, (ActivationBackward,), {}))
    return fwd_cls, bwd_cls


def _even_channels(x):
    return torch.arange(x.shape[-1], device=x.device) % 2 == 0


def _tanhlog(x):
    ax = torch.abs(x)
    return torch.where(ax <= 15.0 / 9.0, A.tanh(x),
                       torch.sign(x) * (torch.log(ax * (9.0 / 15.0))
                                        + 1.7159))


def _dtanhlog(x):
    ax = torch.abs(x)
    return torch.where(ax <= 15.0 / 9.0, A.dtanh(A.tanh(x)),
                       1.0 / torch.clamp_min(ax, 1e-30))


ForwardTanh, BackwardTanh = _pair(
    "activation_tanh", A.tanh, lambda x, y: A.dtanh(y))
ForwardRELU, BackwardRELU = _pair(
    "activation_relu", A.softrelu, lambda x, y: A.dsoftrelu(y))
ForwardStrictRELU, BackwardStrictRELU = _pair(
    "activation_str", A.strict_relu, lambda x, y: A.dstrict_relu(y))
ForwardSigmoid, BackwardSigmoid = _pair(
    "activation_sigmoid", A.sigmoid, lambda x, y: A.dsigmoid(y))
ForwardLog, BackwardLog = _pair(
    "activation_log",
    lambda x: torch.log(x + torch.sqrt(x * x + 1.0)),
    lambda x, y: 1.0 / torch.sqrt(x * x + 1.0))
ForwardMul, BackwardMul = _pair(
    "activation_mul",
    lambda x: x * 1.0,
    lambda x, y: 1.0 + 0.0 * x)
ForwardTanhLog, BackwardTanhLog = _pair(
    "activation_tanhlog", _tanhlog, lambda x, y: _dtanhlog(x))
ForwardSinCos, BackwardSinCos = _pair(
    "activation_sincos",
    lambda x: torch.where(_even_channels(x), torch.sin(x), torch.cos(x)),
    lambda x, y: torch.where(_even_channels(x), torch.cos(x),
                             -torch.sin(x)))
