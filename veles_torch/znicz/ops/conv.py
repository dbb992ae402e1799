"""2-D convolution forward units of the port.

Counterpart of ``veles/znicz_tpu/ops/conv.py``: ``n_kernels``, ``kx``,
``ky``, the ``sliding`` stride, explicit ``padding`` (top, bottom, left,
right) and the five activation variants. Weights keep the reference's
``(n_kernels, ky*kx*C)`` layout, so parameters exchange with it as they
are. Activations are NHWC and contiguous, as in the reference; the
convolution sees them as ``x.permute(0, 3, 1, 2)``, an NCHW view in
channels-last memory (no copy), and the weights as the matching
``(K, C, ky, kx)`` view. The product is one cuDNN convolution through
``TorchDevice.conv2d`` (f32 accumulation of the compute-dtype inputs,
as the reference's ``preferred_element_type=float32``); the bias and the
activation run in f32, the output is stored in ``act_dtype``. Unequal
top/bottom or left/right padding is applied to the input first (cuDNN
pads symmetrically).
"""

from veles_torch.znicz.nn_units import Forward, forward_unit
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops import conv_math as CM


def conv_geometry(x, weights, ky, kx, padding):
    """-> (NCHW view of the NHWC ``x``, padded first where cuDNN cannot,
    KCHW view of the ``(K, ky·kx·C)`` weights, cuDNN's symmetric
    padding) for ``padding`` = (top, bottom, left, right)."""
    top, bottom, left, right = padding
    if top == bottom and left == right:
        pad = (top, left)
    else:
        x = CM.pad_nhwc(x, padding)
        pad = (0, 0)
    w = weights.reshape(weights.shape[0], ky, kx,
                        x.shape[3]).permute(0, 3, 1, 2)
    return x.permute(0, 3, 1, 2), w, pad


class ConvBase(Forward):
    """Convolution: output = act(conv(input, weights) + bias)."""

    ACTIVATION = "linear"

    def __init__(self, n_kernels=None, kx=None, ky=None, sliding=(1, 1),
                 padding=0, **kwargs):
        super().__init__(**kwargs)
        if not all((n_kernels, kx, ky)):
            raise ValueError("%s needs n_kernels, kx, ky"
                             % type(self).__name__)
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        if isinstance(sliding, int):
            sliding = (sliding, sliding)
        self.sliding = tuple(int(s) for s in sliding)
        self.padding = CM.normalize_padding(padding)

    def output_shape_for(self, ishape):
        b, h, w, _ = ishape
        top, bottom, left, right = self.padding
        oy = CM.out_size(h, self.ky, self.sliding[0], top, bottom)
        ox = CM.out_size(w, self.kx, self.sliding[1], left, right)
        return (b, oy, ox, self.n_kernels)

    def initialize(self, input_shape, device):
        """Create the weights for a (B, H, W, C) input on ``device``; ->
        the output shape."""
        self.device = device
        fan_in = self.ky * self.kx * input_shape[3]
        self.init_weights((self.n_kernels, fan_in), fan_in, self.n_kernels)
        return self.output_shape_for(input_shape)

    def conv_geometry(self, x):
        """:func:`conv_geometry` of ``x`` and this unit's weights."""
        return conv_geometry(x, self.weights, self.ky, self.kx,
                             self.padding)

    def forward(self, x):
        xc, w, pad = self.conv_geometry(x)
        v = self.device.conv2d(xc, w, self.sliding, pad) \
            .permute(0, 2, 3, 1)
        if self.include_bias:
            v = v + self.bias
        return A.ACTIVATIONS[self.ACTIVATION][0](v).to(
            self.device.act_dtype).contiguous()


@forward_unit("conv")
class Conv(ConvBase):
    ACTIVATION = "linear"


@forward_unit("conv_tanh")
class ConvTanh(ConvBase):
    ACTIVATION = "tanh"


@forward_unit("conv_relu")
class ConvRELU(ConvBase):
    ACTIVATION = "relu"


@forward_unit("conv_str")
class ConvStrictRELU(ConvBase):
    ACTIVATION = "strict_relu"


@forward_unit("conv_sigmoid")
class ConvSigmoid(ConvBase):
    ACTIVATION = "sigmoid"
