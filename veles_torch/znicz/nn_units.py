"""NN base units of the PyTorch port and its layer registry.

Counterpart of ``veles/znicz_tpu/nn_units.py``:

* :class:`Forward` — an ``nn.Module`` owning ``weights``/``bias``
  buffers, filled from the ``"default"`` numpy generator exactly as the
  reference fills them (same draws at the same seed);
* :class:`GradientDescentBase` — the explicit backward unit: learning
  rates, L2/L1 decay, momentum, ``lr_scale``, and the momentum update
  :meth:`apply_update`. The bias gradient always goes through
  ``ops/bias_grad.bias_grad``: the kernel on the card, its plain version
  on the CPU;
* the registry mapping config names to forward classes and forward
  classes to their GD classes. It is the port's own, separate from the
  reference's, so a process can hold both packages.

The backward is the reference's hand-written GD math, not autograd.
"""

import numpy
import torch
from torch import nn

from veles_torch import prng

_FORWARD_BY_NAME = {}
_GRADIENT_FOR = {}


def forward_unit(name):
    """Class decorator: register a Forward unit under a config name."""
    def deco(cls):
        cls.MAPPING = name
        _FORWARD_BY_NAME[name] = cls
        return cls
    return deco


def gradient_for(forward_cls):
    """Class decorator: register a GD unit as the backward pair of a
    Forward class."""
    def deco(cls):
        cls.FORWARD = forward_cls
        _GRADIENT_FOR[forward_cls] = cls
        return cls
    return deco


def forward_by_name(name):
    try:
        return _FORWARD_BY_NAME[name]
    except KeyError:
        raise KeyError("unknown layer type %r (known: %s)"
                       % (name, ", ".join(sorted(_FORWARD_BY_NAME))))


def gradient_unit_for(forward_cls):
    for cls in forward_cls.__mro__:
        if cls in _GRADIENT_FOR:
            return _GRADIENT_FOR[cls]
    raise KeyError("no gradient unit registered for %s"
                   % forward_cls.__name__)


class Forward(nn.Module):
    """Base forward unit: input -> output with weights/bias buffers."""

    MAPPING = None
    PARAMS = ("weights", "bias")

    def __init__(self, name=None, include_bias=True,
                 weights_transposed=False, weights_filling="uniform",
                 weights_stddev=None, bias_filling="constant",
                 bias_stddev=0.0, prng_key="default"):
        super().__init__()
        self.name = name or type(self).__name__
        self.include_bias = include_bias
        self.weights_transposed = weights_transposed
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        self.prng = prng.get(prng_key)
        #: the TorchDevice this unit computes on (set by initialize)
        self.device = None
        self.register_buffer("weights", None)
        self.register_buffer("bias", None)

    def fill_array(self, arr, filling, stddev):
        if filling == "uniform":
            bound = stddev * numpy.sqrt(3.0)
            self.prng.fill_uniform(arr, -bound, bound)
        elif filling == "gaussian":
            self.prng.fill_normal(arr, 0.0, stddev)
        elif filling == "constant":
            arr[...] = stddev
        else:
            raise ValueError("unknown filling %r" % filling)

    def default_weights_stddev(self, fan_in, fan_out):
        # Glorot scale
        return float(numpy.sqrt(2.0 / (fan_in + fan_out)))

    def init_weights(self, w_shape, fan_in, fan_out):
        """Fill weights (and a non-constant bias) on the host from the
        numpy generator, then place them on the device."""
        stddev = self.weights_stddev or \
            self.default_weights_stddev(fan_in, fan_out)
        w = numpy.zeros(w_shape, numpy.float32)
        self.fill_array(w, self.weights_filling, stddev)
        self.weights = torch.as_tensor(w).to(self.device.device)
        if self.include_bias:
            b = numpy.zeros(fan_out, numpy.float32)
            if self.bias_filling != "constant" or self.bias_stddev:
                self.fill_array(b, self.bias_filling,
                                self.bias_stddev or 0.01)
            self.bias = torch.as_tensor(b).to(self.device.device)

    def export_params(self):
        return {n: getattr(self, n) for n in self.PARAMS
                if getattr(self, n) is not None}


class GradientDescentBase:
    """Base backward unit: err_output -> err_input + parameter update.

    Update rule (the reference's): ``reg = grad + l2·(1−l1_vs_l2)·W +
    l2·l1_vs_l2·sign(W)``; ``vel = moment·vel − lr·reg``; ``W += vel``,
    with separate lr / decay / moment for the bias, and the learning
    rates multiplied by ``lr_scale``.
    """

    FORWARD = None
    ACTIVATION = "linear"
    STATE = ("vel_weights", "vel_bias", "iteration")
    #: reference options this port does not implement yet; a config that
    #: sets one to anything but its default is refused
    UNSUPPORTED = {"solver": "momentum", "accumulate_gradient": 1,
                   "lr_policy": None, "lr_policy_bias": None}

    def __init__(self, name=None, need_err_input=True, learning_rate=0.01,
                 learning_rate_bias=None, weights_decay=0.0,
                 weights_decay_bias=0.0, l1_vs_l2=0.0, l1_vs_l2_bias=None,
                 gradient_moment=0.0, gradient_moment_bias=None,
                 fused_bias_grad=None, **unsupported):
        for key, value in unsupported.items():
            if key not in self.UNSUPPORTED:
                raise TypeError("%s: unknown option %r"
                                % (type(self).__name__, key))
            if value != self.UNSUPPORTED[key]:
                raise NotImplementedError(
                    "%s=%r is not ported yet" % (key, value))
        self.name = name or type(self).__name__
        self.need_err_input = need_err_input
        self.learning_rate = learning_rate
        self.learning_rate_bias = learning_rate if learning_rate_bias is None \
            else learning_rate_bias
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.l1_vs_l2_bias = l1_vs_l2 if l1_vs_l2_bias is None \
            else l1_vs_l2_bias
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = gradient_moment \
            if gradient_moment_bias is None else gradient_moment_bias
        # accepted so layer configs shared with the reference load; the
        # port always takes the bias gradient through ops/bias_grad
        self.fused_bias_grad = fused_bias_grad
        #: multiplier on both learning rates
        self.lr_scale = 1.0
        self.forward = None
        self.vel_weights = None
        self.vel_bias = None
        #: train-minibatch counter (int32 on the device)
        self.iteration = None

    def setup_forward(self, forward):
        """Bind to the paired forward unit."""
        self.forward = forward
        return self

    def initialize(self):
        f = self.forward
        if f is None:
            raise ValueError("%s: setup_forward() not called" % self.name)
        self.vel_weights = torch.zeros_like(f.weights)
        if f.include_bias:
            self.vel_bias = torch.zeros_like(f.bias)
        self.iteration = torch.zeros((), dtype=torch.int32,
                                     device=f.weights.device)

    def export_state(self):
        return {n: getattr(self, n) for n in self.STATE
                if getattr(self, n) is not None}

    def hyperparams(self):
        """The update's scalars, rounded to float32 as the reference's
        traced hyper-parameters are."""
        f32 = numpy.float32
        return {
            "lr": f32(self.learning_rate) * f32(self.lr_scale),
            "lr_bias": f32(self.learning_rate_bias) * f32(self.lr_scale),
            "l2": f32(self.weights_decay),
            "l2_bias": f32(self.weights_decay_bias),
            "l1_vs_l2": f32(self.l1_vs_l2),
            "l1_vs_l2_bias": f32(self.l1_vs_l2_bias),
            "moment": f32(self.gradient_moment),
            "moment_bias": f32(self.gradient_moment_bias),
        }

    @staticmethod
    def apply_update(w, vel, grad, lr, moment, l2, l1_vs_l2):
        """-> (new w, new vel); scalars are float32 numpy values."""
        f32 = numpy.float32
        reg = grad + w * float(l2 * (f32(1.0) - l1_vs_l2)) \
            + torch.sign(w) * float(l2 * l1_vs_l2)
        vel = vel * float(moment) - float(lr) * reg
        return w + vel, vel

    def update_weights(self, grad_w, grad_b):
        """One momentum step of the paired forward's weights and bias."""
        f = self.forward
        h = self.hyperparams()
        f.weights, self.vel_weights = self.apply_update(
            f.weights, self.vel_weights, grad_w.to(f.weights.dtype),
            h["lr"], h["moment"], h["l2"], h["l1_vs_l2"])
        if f.include_bias and grad_b is not None:
            f.bias, self.vel_bias = self.apply_update(
                f.bias, self.vel_bias, grad_b.to(f.bias.dtype),
                h["lr_bias"], h["moment_bias"], h["l2_bias"],
                h["l1_vs_l2_bias"])
        self.iteration += 1
