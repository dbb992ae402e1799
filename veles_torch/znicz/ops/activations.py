"""Activation formula table of the port, on torch tensors.

Counterpart of ``veles/znicz_tpu/ops/activations.py``. Derivatives are
expressed in terms of the forward output ``y`` (backward units keep only
the output):

* tanh:    y = 1.7159·tanh(2/3·x)        dy/dx = ab − (b/a)·y²
* relu:    y = log(1+eˣ)  ("soft" relu)  dy/dx = 1 − e^{−y}
* strict:  y = max(0,x)                  dy/dx = 1[y>0]
* sigmoid: y = σ(x)                      dy/dx = y·(1−y)

The identity derivative (linear, and softmax, whose derivative the
evaluator fuses with cross-entropy) is the python float ``1.0``, so
callers can skip the multiply. ``csrc/bias_grad.cu`` repeats these
derivative formulas in f32.

A constant meets a tensor as JAX's weakly typed Python float does: it is
rounded to the tensor's dtype first (torch would otherwise multiply a
bf16 tensor by the f32 constant), so a bf16 derivative rounds where the
reference's does.
"""

import functools

import torch

TANH_A = 1.7159
TANH_B = 2.0 / 3.0


def linear(v):
    return v


def dlinear(y):
    return 1.0


def tanh(v):
    return TANH_A * torch.tanh(TANH_B * v)


@functools.lru_cache(maxsize=None)
def _const(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def dtanh(y):
    return _const(TANH_A * TANH_B, y.dtype) \
        - _const(TANH_B / TANH_A, y.dtype) * y * y


def softrelu(v):
    # log(1+exp(v)) without overflow
    return torch.logaddexp(torch.zeros_like(v), v)


def dsoftrelu(y):
    return 1.0 - torch.exp(-y)


def strict_relu(v):
    return torch.clamp_min(v, 0.0)


def dstrict_relu(y):
    return (y > 0.0).to(y.dtype)


def sigmoid(v):
    return 0.5 * (torch.tanh(0.5 * v) + 1.0)


def dsigmoid(y):
    return y * (1.0 - y)


def softmax(v):
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


#: name -> (forward(v), derivative_by_output(y))
ACTIVATIONS = {
    "linear": (linear, dlinear),
    "tanh": (tanh, dtanh),
    "relu": (softrelu, dsoftrelu),
    "strict_relu": (strict_relu, dstrict_relu),
    "sigmoid": (sigmoid, dsigmoid),
    "softmax": (softmax, dlinear),
}


def is_identity(activation):
    """True when ``activation``'s derivative-by-output is the identity."""
    return ACTIVATIONS[activation][1] is dlinear
