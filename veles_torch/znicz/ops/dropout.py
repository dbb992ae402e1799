"""Dropout unit pair of the port.

Counterpart of ``veles/znicz_tpu/ops/dropout.py``: in train mode the
forward multiplies by the mask ``(u < keep) / keep`` in the activation
dtype, ``u`` uniform in [0, 1) and ``keep = 1 − dropout_ratio``
(inverted dropout, so eval needs no rescale); in eval mode (``.eval()``)
it is the identity. The backward masks the error with the same mask.
The uniforms come from an explicit ``torch.Generator`` per unit
(``prng.torch_generator``), which cannot reproduce the reference's
``jax.random`` bits: parity is tested with the mask injected
(:meth:`DropoutForward.draw_mask`) and statistically.

On a mesh (``mesh`` set by ``parallel.setup_data_parallel`` /
``setup_sequence_parallel``) every rank draws the mask of the WHOLE
minibatch from its generator (seeded alike on every rank, so the
generators stay in step) and keeps its rows (the ``data`` axes) and its
positions (``seq``): the ranks' masks put together are the one device's.
"""

import torch

from veles_torch import prng
from veles_torch.znicz.nn_units import (
    Forward, RoutingGradientBase, forward_unit, gradient_for)


@forward_unit("dropout")
class DropoutForward(Forward):
    PARAMS = ()

    def __init__(self, dropout_ratio=0.5, prng_key="dropout", **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.dropout_ratio = float(dropout_ratio)
        self.prng_key = prng_key
        self.generator = None
        #: the mask of the last train forward
        self.mask = None
        #: the mesh, its batch axes and ``seq`` axis (parallel setups)
        self.mesh = None
        self.batch_axes = ()
        self.seq_axis = None

    def initialize(self, input_shape, device):
        self.device = device
        self.generator = prng.torch_generator(
            "%s/%s" % (self.prng_key, self.name), device.device)
        return tuple(input_shape)

    def get_state(self):
        """The generator's state (a checkpoint's ``units`` section), so a
        resumed run draws what an uninterrupted one would."""
        return {"generator": prng.generator_state(self.generator)}

    def set_state(self, state):
        prng.set_generator_state(self.generator, state["generator"])

    def draw_mask(self, x):
        """``(u < keep) / keep`` in the activation dtype, x's shape; on a
        mesh this rank's part of the minibatch's mask."""
        keep = 1.0 - self.dropout_ratio
        shape = list(x.shape)
        mesh = self.mesh
        nb = mesh.axis_size(self.batch_axes) if mesh is not None else 1
        ns = mesh.shape[self.seq_axis] if self.seq_axis else 1
        shape[0] *= nb
        if ns > 1:
            shape[1] *= ns
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if nb > 1:
            lo = mesh.index(self.batch_axes) * x.shape[0]
            u = u[lo:lo + x.shape[0]]
        if ns > 1:
            lo = mesh.index(self.seq_axis) * x.shape[1]
            u = u[:, lo:lo + x.shape[1]]
        return (u < keep).to(self.device.act_dtype) / keep

    def forward(self, x):
        if not self.training:
            return x
        self.mask = self.draw_mask(x)
        return (x * self.mask).to(self.device.act_dtype)


@gradient_for(DropoutForward)
class DropoutBackward(RoutingGradientBase):
    def run(self, x, y, err):
        if not self.need_err_input:
            return None
        mask = self.forward.mask
        return (err.reshape(mask.shape) * mask).to(
            self.forward.device.act_dtype)
