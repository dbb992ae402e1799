"""On-device input normalization of the port.

Counterpart of ``veles/znicz_tpu/ops/mean_disp_normalizer.py``:
``y = (x − mean)·rdisp`` with per-feature ``mean`` and reciprocal
dispersion ``rdisp`` arrays, fixed before the unit initializes (from a
loader's fitted normalizer: ``normalizer.mean_rdisp(sample_shape)``,
``veles_torch/normalization.py``). No parameters. Computed in f32, stored
in ``act_dtype``.

The reference registers no backward unit for it. The port's
:class:`GDMeanDispNormalizer` is the exact adjoint, ``err·rdisp``, so a
stack may start with this unit; as the first unit it passes nothing on.
"""

import torch

from veles_torch.znicz.nn_units import (
    Forward, RoutingGradientBase, forward_unit, gradient_for)


@forward_unit("mean_disp_normalizer")
class MeanDispNormalizer(Forward):
    PARAMS = ()

    def __init__(self, mean=None, rdisp=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        #: per-feature arrays broadcast against one sample
        self.mean = mean
        self.rdisp = rdisp

    def output_shape_for(self, ishape):
        return tuple(ishape)

    def initialize(self, input_shape, device):
        if self.mean is None or self.rdisp is None:
            raise ValueError("%s needs mean and rdisp set" % self.name)
        self.device = device
        self.mean, self.rdisp = (
            torch.as_tensor(a).to(device=device.device, dtype=torch.float32)
            for a in (self.mean, self.rdisp))
        return self.output_shape_for(input_shape)

    def forward(self, x):
        return ((x.to(torch.float32) - self.mean) * self.rdisp).to(
            self.device.act_dtype)


@gradient_for(MeanDispNormalizer)
class GDMeanDispNormalizer(RoutingGradientBase):
    """err_input = err_output·rdisp (the forward's adjoint)."""

    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        f = self.forward
        return (err.reshape(y.shape).to(torch.float32) * f.rdisp).to(
            f.device.act_dtype)
