"""Token embedding unit pair of the PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/embedding.py``: a (vocab, dim)
lookup table with the fixed sinusoidal positional encoding added; the
backward scatter-adds the error rows into an f32 table gradient with
``index_add_`` (on the card that op sums with atomics, so repeated ids
add in no fixed order).
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)


def sinusoidal_positions(seq_len, dim):
    """(seq_len, dim) float32: sin on even, cos on odd features."""
    pos = numpy.arange(seq_len, dtype=numpy.float32)[:, None]
    i = numpy.arange(dim, dtype=numpy.float32)[None, :]
    angle = pos / numpy.power(10000.0, (2.0 * (i // 2)) / dim)
    enc = numpy.where(i.astype(numpy.int64) % 2 == 0,
                      numpy.sin(angle), numpy.cos(angle))
    return enc.astype(numpy.float32)


@forward_unit("embedding")
class EmbeddingForward(Forward):
    """ids (B, S) int -> (B, S, D) in ``act_dtype``, + positions."""

    PARAMS = ("weights",)

    def __init__(self, vocab_size=None, dim=None, add_positions=True,
                 **kwargs):
        super().__init__(**kwargs)
        if not (vocab_size and dim):
            raise ValueError("embedding needs vocab_size and dim")
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.add_positions = add_positions
        self.include_bias = False
        self.positions = None

    def initialize(self, input_shape, device):
        self.device = device
        self.init_weights((self.vocab_size, self.dim), self.vocab_size,
                          self.dim)
        if self.add_positions:
            self.positions = torch.as_tensor(sinusoidal_positions(
                input_shape[1], self.dim)).to(device.device)
        return tuple(input_shape) + (self.dim,)

    def forward(self, ids):
        y = self.weights[ids.long()]
        if self.positions is not None:
            y = y + self.positions
        return y.to(self.device.act_dtype)


@gradient_for(EmbeddingForward)
class GDEmbedding(GradientDescentBase):
    """Scatter-add error rows into the table; no err_input (ids are not
    differentiable)."""

    def __init__(self, need_err_input=False, **kwargs):
        super().__init__(need_err_input=need_err_input, **kwargs)

    def run(self, x, y, err):
        f = self.forward
        grad = torch.zeros((f.vocab_size, f.dim), dtype=torch.float32,
                           device=f.weights.device)
        grad.index_add_(0, x.reshape(-1).long(),
                        err.reshape(-1, f.dim).to(torch.float32))
        self.update_weights(grad, None)
        return None
