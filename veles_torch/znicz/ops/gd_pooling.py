"""Pooling backward units of the port.

Counterpart of ``veles/znicz_tpu/ops/gd_pooling.py``: the max variants
(max, max-abs, stochastic) route each window's error to the winner the
forward recorded; the average spreads it evenly over the window's true
cells. Windows that overlap (AlexNet's 3×3 pools with stride 2) add into
the same input element. The adds run tap after tap in window order into
an f32 tensor the size of the padded input (``conv_math.scatter_taps``),
with no atomics, so two launches give the same bits; the cells past the
edge are cut off and the result is stored in ``act_dtype``. No
parameters: these units only transform the error.
"""

import torch

from veles_torch.znicz.nn_units import RoutingGradientBase, gradient_for
from veles_torch.znicz.ops import conv_math as CM
from veles_torch.znicz.ops.pooling import (
    MaxPooling, MaxAbsPooling, AvgPooling, StochasticPooling)


class GDPoolingBase(RoutingGradientBase):
    """Routes err_output through the windows."""

    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        err = err.reshape(y.shape)
        b, h, w, c = x.shape
        need_h, need_w = f.padded_hw(x.shape)
        acc = CM.scatter_taps(self.piece(x, err), (b, need_h, need_w, c),
                              f.ky, f.kx, f.sliding)
        return acc[:, :h, :w, :].to(f.device.act_dtype).contiguous()

    def piece(self, x, err):
        """-> tap t -> the (B, oy, ox, C) error that tap receives."""
        raise NotImplementedError


class GDMaxPoolingBase(GDPoolingBase):
    def piece(self, x, err):
        sel = self.forward.input_offset
        zero = torch.zeros((), dtype=err.dtype, device=err.device)
        return lambda t: torch.where(sel == t, err, zero)


@gradient_for(MaxPooling)
class GDMaxPooling(GDMaxPoolingBase):
    pass


@gradient_for(MaxAbsPooling)
class GDMaxAbsPooling(GDMaxPoolingBase):
    pass


@gradient_for(StochasticPooling)
class GDStochasticPooling(GDMaxPoolingBase):
    pass


@gradient_for(AvgPooling)
class GDAvgPooling(GDPoolingBase):
    def piece(self, x, err):
        spread = err.to(torch.float32) \
            / self.forward.window_counts(x.shape, err.device)
        return lambda t: spread
