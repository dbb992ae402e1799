"""The stacked transformer-block unit pair of the port.

Counterpart of ``veles/znicz_tpu/ops/transformer_stack.py``: ONE unit
owning ``layers`` identical post-LN blocks (MHA + residual -> LN -> FFN
+ residual -> LN, the block the per-layer LM builds from attention,
layernorm and transformer_ffn units), every parameter stacked along a
leading layer dimension under the reference's names. The math is
``parallel/pipeline.py``'s; attention inside the stack is the dense
formulation. Eager PyTorch walks the layers in a Python loop.

``x`` is cast to f32 at the stack's boundary, as the reference's scan
carry is. ``remat=True`` keeps only each layer's input through the
forward and recomputes a layer's cache in the backward (one more block
forward per layer) instead of holding every layer's (B, H, S, S)
probabilities; the step is bit for bit the same.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.parallel import pipeline as PL


@forward_unit("transformer_stack")
class TransformerBlockStack(Forward):
    """N identical transformer blocks with stacked (L, ...) params."""

    PARAMS = PL.PARAMS

    def __init__(self, layers=None, heads=4, hidden=None, causal=True,
                 eps=1e-5, remat=False, **kwargs):
        super().__init__(**kwargs)
        if not layers:
            raise ValueError("transformer_stack needs layers >= 1")
        self.layers = int(layers)
        self.heads = int(heads)
        self.hidden = hidden
        self.causal = causal
        self.eps = float(eps)
        self.remat = bool(remat)
        #: the forward's stash for the GD unit: a cache per layer, or
        #: with ``remat`` each layer's input
        self.cache = None

    def initialize(self, input_shape, device):
        self.device = device
        _, _, d = input_shape
        if d % self.heads:
            raise ValueError("dim %d not divisible by %d heads"
                             % (d, self.heads))
        n, h = self.layers, self.hidden or 4 * d
        self.hidden = h

        def filled(shape, fan_in, fan_out):
            arr = numpy.zeros(shape, numpy.float32)
            self.fill_array(arr, self.weights_filling,
                            self.weights_stddev
                            or self.default_weights_stddev(fan_in, fan_out))
            return arr

        # the reference's fill order: the numpy generator's draws match
        host = {"weights": filled((n, d, 3 * d), d, 3 * d),
                "bias": numpy.zeros((n, 3 * d), numpy.float32),
                "weights_out": filled((n, d, d), d, d),
                "bias_out": numpy.zeros((n, d), numpy.float32),
                "ln1_g": numpy.ones((n, d), numpy.float32),
                "ln1_b": numpy.zeros((n, d), numpy.float32),
                "ffn_w1": filled((n, d, h), d, h),
                "ffn_b1": numpy.zeros((n, h), numpy.float32),
                "ffn_w2": filled((n, h, d), h, d),
                "ffn_b2": numpy.zeros((n, d), numpy.float32),
                "ln2_g": numpy.ones((n, d), numpy.float32),
                "ln2_b": numpy.zeros((n, d), numpy.float32)}
        for name in self.PARAMS:
            setattr(self, name, torch.as_tensor(host[name]).to(
                device.device))
        return tuple(input_shape)

    def params(self):
        return {name: getattr(self, name) for name in self.PARAMS}

    def forward(self, x):
        x = x.to(torch.float32)
        run = PL.stack_fwd_remat if self.remat else PL.stack_fwd
        y, self.cache = run(self.params(), x, self.heads, self.causal,
                            self.eps, self.device.dot)
        return y.to(self.device.act_dtype)


@gradient_for(TransformerBlockStack)
class GDTransformerBlockStack(GradientDescentBase):
    """Reverse loop over the layers (recomputing each layer's cache with
    ``remat``); the weights/bias update and every other parameter's in
    lockstep through ``EXTRA_PARAMS``."""

    EXTRA_PARAMS = (("weights_out", False), ("bias_out", True),
                    ("ln1_g", False), ("ln1_b", True),
                    ("ffn_w1", False), ("ffn_b1", True),
                    ("ffn_w2", False), ("ffn_b2", True),
                    ("ln2_g", False), ("ln2_b", True))

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        x = x.to(torch.float32)
        err = err.reshape(x.shape).to(torch.float32)
        if f.remat:
            dx, grads = PL.stack_bwd_remat(f.params(), f.cache, err,
                                           f.heads, f.causal, f.eps,
                                           dev.dot)
        else:
            dx, grads = PL.stack_bwd(f.params(), f.cache, err, f.heads,
                                     f.eps, dev.dot)
        f.cache = None
        self.update_weights(grads["weights"], grads["bias"])
        self.update_extra(grads)
        return dx.to(dev.act_dtype) if self.need_err_input else None
