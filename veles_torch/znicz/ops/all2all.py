"""Fully-connected forward units of the PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/all2all.py``: ``output =
act(input·W + b)`` with the product through ``TorchDevice.dot`` (inputs
in ``compute_dtype``, f32 result) and the output stored in ``act_dtype``
— except softmax, whose probabilities stay f32 (they feed log() in the
evaluator).

Weights layout: ``(input_features, neurons)``; ``weights_transposed=True``
stores ``(neurons, input_features)``.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import Forward, forward_unit
from veles_torch.znicz.ops import activations as A


class All2AllBase(Forward):
    """Dense layer: output = act(input·W + b)."""

    ACTIVATION = "linear"
    #: keep the output in f32 whatever the activation dtype policy
    OUTPUT_F32 = False

    def __init__(self, output_sample_shape=None, **kwargs):
        super().__init__(**kwargs)
        if output_sample_shape is None:
            raise ValueError("%s needs output_sample_shape (neuron count)"
                             % type(self).__name__)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)
        self.neurons = int(numpy.prod(self.output_sample_shape))

    def initialize(self, input_shape, device):
        """Create the parameters for a ``(batch, ...)`` input on
        ``device`` (a TorchDevice); -> the output shape."""
        self.device = device
        fan_in = int(numpy.prod(input_shape[1:]))
        w_shape = (self.neurons, fan_in) if self.weights_transposed \
            else (fan_in, self.neurons)
        self.init_weights(w_shape, fan_in, self.neurons)
        return (input_shape[0],) + self.output_sample_shape

    def forward(self, x):
        x2 = x.reshape(x.shape[0], -1)
        w = self.weights.t() if self.weights_transposed else self.weights
        v = self.device.dot(x2, w)
        if self.include_bias:
            v = v + self.bias
        y = A.ACTIVATIONS[self.ACTIVATION][0](v)
        y = y.reshape((x.shape[0],) + self.output_sample_shape)
        return y.to(torch.float32 if self.OUTPUT_F32
                    else self.device.act_dtype)


@forward_unit("all2all")
class All2All(All2AllBase):
    ACTIVATION = "linear"


@forward_unit("all2all_tanh")
class All2AllTanh(All2AllBase):
    ACTIVATION = "tanh"


@forward_unit("all2all_relu")
class All2AllRELU(All2AllBase):
    ACTIVATION = "relu"


@forward_unit("all2all_str")
class All2AllStrictRELU(All2AllBase):
    ACTIVATION = "strict_relu"


@forward_unit("all2all_sigmoid")
class All2AllSigmoid(All2AllBase):
    ACTIVATION = "sigmoid"


@forward_unit("softmax")
class All2AllSoftmax(All2AllBase):
    """Dense + softmax; also records the argmax of each row
    (``max_idx``)."""

    ACTIVATION = "softmax"
    OUTPUT_F32 = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.max_idx = None

    def forward(self, x):
        y = super().forward(x)
        self.max_idx = torch.argmax(y, dim=-1).to(torch.int32)
        return y
