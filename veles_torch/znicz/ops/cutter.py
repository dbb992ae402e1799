"""Tensor surgery units of the port.

Counterpart of ``veles/znicz_tpu/ops/cutter.py``:

* :class:`Cutter` crops a spatial window out of an NHWC batch, given as
  the reference's ``padding`` = (left, top, right, bottom) to cut away or
  as ``y``, ``x`` and an optional ``h``, ``w``; :class:`GDCutter`
  scatters the error back into zeros of the input's shape;
* :class:`ZeroFiller` pins chosen weight entries of a forward unit at 0.
  Its mask becomes the unit's ``zero_mask``, which its GD unit multiplies
  into the weights inside every update (``GradientDescentBase.
  update_weights``), once per step, as the reference's traced update
  does; it is applied once to the initial weights too, and never as a
  host hook after the step. The mask is a device tensor: an edit in
  place (``zf.mask[...] = ...``) reaches the next update.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, RoutingGradientBase, forward_unit, gradient_for)


@forward_unit("cutter")
class Cutter(Forward):
    """output = input[:, y:y+h, x:x+w, :]."""

    PARAMS = ()

    def __init__(self, padding=None, y=0, x=0, h=None, w=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        if padding is not None:       # the reference's (l, t, r, b)
            left, top, right, bottom = padding
            self.y, self.x = int(top), int(left)
            self._trim = (int(bottom), int(right))
            self.h = self.w = None
        else:
            self.y, self.x, self.h, self.w = y, x, h, w
            self._trim = None

    def output_shape_for(self, ishape):
        b, hh, ww, c = ishape
        if self._trim is not None:
            bottom, right = self._trim
            return (b, hh - self.y - bottom, ww - self.x - right, c)
        return (b, self.h or hh - self.y, self.w or ww - self.x, c)

    def initialize(self, input_shape, device):
        self.device = device
        oshape = self.output_shape_for(input_shape)
        if min(oshape[1:3]) <= 0:
            raise ValueError("%s cuts away everything" % self.name)
        return oshape

    def forward(self, x):
        _, h, w, _ = self.output_shape_for(x.shape)
        return x[:, self.y:self.y + h, self.x:self.x + w, :].contiguous()


@gradient_for(Cutter)
class GDCutter(RoutingGradientBase):
    """Scatter the error back into a zero tensor of the input shape."""

    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        err = err.reshape(y.shape)
        ei = torch.zeros(x.shape, dtype=f.device.act_dtype, device=err.device)
        ei[:, f.y:f.y + err.shape[1], f.x:f.x + err.shape[2], :] = err
        return ei


class ZeroFiller:
    """Keeps the masked weight entries of ``target`` (a forward unit) at
    0. ``mask`` (array or tensor of the weights' shape; all ones when
    None) becomes the target's ``zero_mask`` at :meth:`initialize`, on the
    weights' device; from then on ``mask`` is that tensor."""

    def __init__(self, target=None, mask=None, name="zerofiller"):
        self.target = target
        self.name = name
        self._initial = mask

    @property
    def mask(self):
        z = self.target.zero_mask
        return self._initial if z is None else z

    def initialize(self):
        w = self.target.weights
        if w is None:
            raise ValueError("%s: %s has no weights" % (self.name,
                                                        self.target.name))
        mask = torch.ones_like(w) if self._initial is None else \
            torch.as_tensor(self._initial).to(device=w.device, dtype=w.dtype)
        if tuple(mask.shape) != tuple(w.shape):
            raise ValueError("%s: mask %s for weights %s" % (
                self.name, tuple(mask.shape), tuple(w.shape)))
        self.target.zero_mask = mask
        self.target.weights = w * mask
        return self
