"""Local response normalization (AlexNet's cross-map LRN) of the port.

Counterpart of ``veles/znicz_tpu/ops/normalization.py``, with its own
formula (``torch.nn.functional.local_response_norm`` divides ``alpha``
by ``n`` and works on NCHW; this does not):

    d(i)   = k + alpha · Σ_{j∈win(i)} x(j)²        (window over channels)
    y(i)   = x(i) · d(i)^{-beta}
    dx(i)  = dy(i)·d(i)^{-beta}
             − 2αβ·x(i)·Σ_{j: i∈win(j)} dy(j)·x(j)·d(j)^{-beta-1}

``beta == 0.75`` (AlexNet's) is computed as ``1/sqrt(d·sqrt(d))``, as in
the reference. Both directions compute in the flowing dtype (bf16 on the
card), as the reference does.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, RoutingGradientBase, forward_unit, gradient_for)
from veles_torch.znicz.ops import conv_math as CM


def lrn_denominator(x, alpha, n, k):
    """``k + alpha·Σ x²`` over the centered window of ``n`` channels."""
    return k + alpha * CM.sliding_channel_sum(x * x, n)


def lrn_dpow(d, beta):
    """``d ** (-beta)``; for beta 0.75 two square roots and a multiply,
    as the reference. The roots are ``torch.pow(·, 0.5)``, which CUDA
    computes as its square root: ``torch.sqrt`` of float32 on the CPU
    (torch 2.13.0+cpu on an AVX512 host) returned roots off in their
    fourth digit on some runs, the power never."""
    if beta == 0.75:
        return 1.0 / torch.pow(d * torch.pow(d, 0.5), 0.5)
    return d ** (-beta)


@forward_unit("norm")
class LRNormalizerForward(Forward):
    """Cross-map LRN (no weights)."""

    PARAMS = ()

    def __init__(self, alpha=0.0001, beta=0.75, n=5, k=2.0, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.n = int(n)
        self.k = float(k)

    def initialize(self, input_shape, device):
        self.device = device
        return tuple(input_shape)

    def dpow(self, d):
        return lrn_dpow(d, self.beta)

    def denominator(self, x):
        return lrn_denominator(x, self.alpha, self.n, self.k)

    def forward(self, x):
        y = x * self.dpow(self.denominator(x))
        return y.to(self.device.act_dtype)


@gradient_for(LRNormalizerForward)
class LRNormalizerBackward(RoutingGradientBase):
    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        err = err.reshape(x.shape)
        d = f.denominator(x)
        dpow = f.dpow(d)
        inner = err * x * dpow / d
        spread = CM.sliding_channel_sum(inner, f.n, reverse=True)
        ei = err * dpow - 2.0 * f.alpha * f.beta * x * spread
        return ei.to(f.device.act_dtype)
