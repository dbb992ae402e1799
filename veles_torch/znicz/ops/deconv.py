"""Deconvolution (transposed convolution) and depooling units of the port:
the autoencoder path.

Counterpart of ``veles/znicz_tpu/ops/deconv.py``:

* :class:`Deconv` — input (B, oy, ox, K) -> output (B, H, W, C): the
  convolution's input gradient, with the weights in ``Conv``'s layout
  ``(n_kernels, ky·kx·C)`` (``fan_in = ky·kx·C``), so an autoencoder can
  tie them. The product is one transposed convolution through
  ``TorchDevice.conv_transpose2d`` (the conv policy: compute-dtype-rounded
  operands, f32 sums); its full (sy·(oy−1)+ky, sx·(ox−1)+kx) overlap-add
  is then cut to the (H, W) window at (top, left) (``conv_math.
  crop_nhwc``), zero where the stride remainders ``ry``, ``rx`` reach past
  it. ``conv_transpose2d`` pads only symmetrically, so the port pads and
  crops itself. No bias, as in the reference.
* :class:`GDDeconv` — ``err_input`` is the forward convolution of the
  error with the same weights (``TorchDevice.conv2d``); the weight
  gradient is that convolution's weight gradient with the deconv's input
  as the output error (``TorchDevice.conv2d_grads``), at any stride: one
  cuDNN call where the reference switches to an im2col GEMM at stride > 1
  (its TPU fast path).
* :class:`Depooling` — spreads each value evenly over its ky×kx window
  (the adjoint of average pooling); :class:`GDDepooling` averages the
  error back over each window. Both walk the window's taps
  (``conv_math.scatter_taps`` / ``window_taps``), in f32, tap after tap,
  with no atomics, so overlapping windows (sliding < k) give the same
  bits on every launch.

``output_shape_source`` (an earlier forward unit, or a shape whose first
entry stands for the batch) pins the output to that unit's *input* shape,
as the reference links a mirrored conv's input. The serving plane calls
:func:`deconv_fwd` and :func:`depool`, the units' own math.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, RoutingGradientBase, forward_unit,
    gradient_for)
from veles_torch.znicz.ops import conv_math as CM
from veles_torch.znicz.ops.conv import conv_geometry


def source_shape(src, batch):
    """(batch, H, W, C) pinned by ``output_shape_source``: a forward unit
    (its input shape) or a shape; None when unset."""
    if src is None:
        return None
    shape = src.input_shape if isinstance(src, Forward) else src
    if shape is None:
        raise ValueError("output_shape_source %s is not initialized"
                         % getattr(src, "name", src))
    return (batch,) + tuple(int(d) for d in shape[1:])


def deconv_fwd(x, weights, ky, kx, sliding, padding, out_hw,
               conv_transpose):
    """(B, oy, ox, K) NHWC ``x`` through the ``(K, ky·kx·C)`` weights ->
    the (B, H, W, C) transposed convolution cut to ``out_hw`` = (H, W) at
    (top, left) of ``padding``; ``conv_transpose(x_nchw, w, stride)`` is
    the unpadded transposed convolution (the device's, or f32)."""
    k = x.shape[3]
    c = weights.shape[1] // (ky * kx)
    w = weights.reshape(k, ky, kx, c).permute(0, 3, 1, 2)
    full = conv_transpose(x.permute(0, 3, 1, 2), w, tuple(sliding)) \
        .permute(0, 2, 3, 1)
    top, _, left, _ = padding
    return CM.crop_nhwc(full, top, left, *out_hw)


def depool(x, ky, kx, sliding, out_hw):
    """Spread (B, oy, ox, C) ``x`` / (ky·kx) over each window, in f32, and
    keep the (H, W) = ``out_hw`` top-left corner."""
    b, oy, ox, c = x.shape
    sy, sx = sliding
    share = x.to(torch.float32) / float(ky * kx)
    full = CM.scatter_taps(lambda t: share,
                           (b, sy * (oy - 1) + ky, sx * (ox - 1) + kx, c),
                           ky, kx, sliding)
    return full[:, :out_hw[0], :out_hw[1], :]


@forward_unit("deconv")
class Deconv(Forward):
    """Transposed convolution: input (B, oy, ox, K) -> output (B, H, W,
    C)."""

    def __init__(self, n_kernels=None, kx=None, ky=None, sliding=(1, 1),
                 padding=0, n_channels=None, output_shape_source=None,
                 include_bias=False, **kwargs):
        if include_bias:
            raise ValueError("Deconv has no bias (the reference's neither "
                             "adds nor updates one)")
        super().__init__(include_bias=False, **kwargs)
        if not all((n_kernels, kx, ky)):
            raise ValueError("Deconv needs n_kernels, kx, ky")
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        if isinstance(sliding, int):
            sliding = (sliding, sliding)
        self.sliding = tuple(int(s) for s in sliding)
        self.padding = CM.normalize_padding(padding)
        self.n_channels = n_channels
        self.output_shape_source = output_shape_source
        #: the resolved (H, W, C) of the output
        self.out_shape = None

    def output_shape_for(self, ishape):
        b, oy, ox, _ = ishape
        pinned = source_shape(self.output_shape_source, b)
        if pinned is not None:
            return pinned
        top, bottom, left, right = self.padding
        sy, sx = self.sliding
        return (b, sy * (oy - 1) + self.ky - top - bottom,
                sx * (ox - 1) + self.kx - left - right,
                self.n_channels or self.n_kernels)

    def initialize(self, input_shape, device):
        """Create the weights for a (B, oy, ox, K) input on ``device``; ->
        the output shape. The output must be what a convolution of this
        geometry maps back onto (oy, ox)."""
        self.device = device
        oshape = self.output_shape_for(input_shape)
        top, bottom, left, right = self.padding
        back = (CM.out_size(oshape[1], self.ky, self.sliding[0], top,
                            bottom),
                CM.out_size(oshape[2], self.kx, self.sliding[1], left,
                            right))
        if back != tuple(input_shape[1:3]) \
                or input_shape[3] != self.n_kernels:
            raise ValueError(
                "%s: output %s does not convolve back to the input %s"
                % (self.name, oshape[1:], tuple(input_shape[1:])))
        self.out_shape = tuple(oshape[1:])
        fan_in = self.ky * self.kx * oshape[3]
        self.init_weights((self.n_kernels, fan_in), self.n_kernels, fan_in)
        return oshape

    def forward(self, x):
        y = deconv_fwd(x, self.weights, self.ky, self.kx, self.sliding,
                       self.padding, self.out_shape[:2],
                       self.device.conv_transpose2d)
        return y.to(self.device.act_dtype).contiguous()


@gradient_for(Deconv)
class GDDeconv(GradientDescentBase):
    """Backward of the deconvolution: err_input by the forward
    convolution, the weight gradient by that convolution's."""

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        ec, w, pad = conv_geometry(err.reshape(y.shape), f.weights, f.ky,
                                   f.kx, f.padding)
        err_input = None
        if self.need_err_input:
            err_input = dev.conv2d(ec, w, f.sliding, pad) \
                .permute(0, 2, 3, 1).to(dev.act_dtype).contiguous()
        _, gw = dev.conv2d_grads(x.permute(0, 3, 1, 2), ec, w, f.sliding,
                                 pad, need_input=False)
        self.update_weights(gw.permute(0, 2, 3, 1).reshape(f.n_kernels, -1),
                            None)
        return err_input


@forward_unit("depooling")
class Depooling(Forward):
    """Upsample by spreading each value over its ky×kx window."""

    PARAMS = ()

    def __init__(self, kx=2, ky=2, sliding=None, output_shape_source=None,
                 **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)
        if isinstance(sliding, int):
            sliding = (sliding, sliding)
        self.sliding = tuple(int(s) for s in sliding)
        self.output_shape_source = output_shape_source
        #: the resolved (H, W, C) of the output
        self.out_shape = None

    def spread_hw(self, ishape):
        """(H, W) of the full spread of a (B, oy, ox, C) input."""
        sy, sx = self.sliding
        return (sy * (ishape[1] - 1) + self.ky,
                sx * (ishape[2] - 1) + self.kx)

    def output_shape_for(self, ishape):
        pinned = source_shape(self.output_shape_source, ishape[0])
        return pinned or (ishape[0],) + self.spread_hw(ishape) + \
            (ishape[3],)

    def initialize(self, input_shape, device):
        self.device = device
        oshape = self.output_shape_for(input_shape)
        need_h, need_w = self.spread_hw(input_shape)
        if oshape[1] > need_h or oshape[2] > need_w \
                or oshape[3] != input_shape[3]:
            raise ValueError("%s: output %s beyond the spread of %s"
                             % (self.name, oshape[1:],
                                tuple(input_shape[1:])))
        self.out_shape = tuple(oshape[1:])
        return oshape

    def forward(self, x):
        return depool(x, self.ky, self.kx, self.sliding,
                      self.out_shape[:2]).to(self.device.act_dtype) \
            .contiguous()


@gradient_for(Depooling)
class GDDepooling(RoutingGradientBase):
    """Adjoint of the spread: the error averaged over each window (zero
    past the output's edge), tap after tap in f32."""

    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        _, oy, ox, _ = x.shape
        need_h, need_w = f.spread_hw(x.shape)
        err = CM.pad_nhwc(err.reshape(y.shape).to(torch.float32),
                          (0, need_h - y.shape[1], 0, need_w - y.shape[2]))
        total = None
        for _, piece in CM.window_taps(err, f.ky, f.kx, f.sliding, oy, ox):
            total = piece.clone() if total is None else total.add_(piece)
        return (total / float(f.ky * f.kx)).to(f.device.act_dtype)
