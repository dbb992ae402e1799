"""LayerNorm unit pair of the PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/layernorm.py``: normalises over the
trailing (feature) dimension with a learned gain (``weights``, ones at
start) and bias (zeros). Statistics and the backward run in f32 whatever
the activation dtype, as the reference's traced path does; the bias
gradient is a column sum through ``ops/bias_grad.bias_grad``.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.ops.bias_grad import bias_grad


def ln_fwd(x, g, b, eps):
    """LayerNorm over the trailing dim of an f32 ``x``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    return (xc * rstd) * g + b


def ln_bwd(x, g, err, eps):
    """Backward of :func:`ln_fwd` on f32 ``x``/``err``: (dx, dg, db), with
    dg/db reduced over every leading dim."""
    d = x.shape[-1]
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    xhat = xc * rstd
    dg = (err * xhat).reshape(-1, d).sum(dim=0)
    err2 = err.reshape(-1, d).contiguous()
    db = bias_grad(err2, err2, "linear")
    dxhat = err * g
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd
    return dx, dg, db


@forward_unit("layernorm")
class LayerNormForward(Forward):
    """y = LN(x)·gain + bias over the last axis; params ``weights`` (gain)
    and ``bias``."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.eps = float(eps)

    def initialize(self, input_shape, device):
        self.device = device
        d = input_shape[-1]
        self.weights = torch.ones(d, dtype=torch.float32,
                                  device=device.device)
        self.bias = torch.zeros(d, dtype=torch.float32,
                                device=device.device)
        return tuple(input_shape)

    def forward(self, x):
        return ln_fwd(x.to(torch.float32), self.weights, self.bias,
                      self.eps).to(self.device.act_dtype)


@gradient_for(LayerNormForward)
class GDLayerNorm(GradientDescentBase):

    def run(self, x, y, err):
        f = self.forward
        x = x.to(torch.float32)
        dx, dg, db = ln_bwd(x, f.weights,
                            err.reshape(x.shape).to(torch.float32), f.eps)
        self.update_weights(dg, db)
        return dx.to(f.device.act_dtype) if self.need_err_input else None
