"""Token embedding unit pair of the PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/embedding.py``: a (vocab, dim)
lookup table with the fixed sinusoidal positional encoding added; the
backward sums the error rows of each id into an f32 table gradient
(:func:`embedding_grad`) in a fixed order, so two runs on the card give
the same bits (``index_add_`` would add repeated ids with atomics, in no
fixed order). Under sequence parallelism a rank embeds its ``S/n``
positions of each sample, and its positions start at its global offset
(:meth:`EmbeddingForward.shard_positions`), not at 0.
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


def embedding_grad(ids, err, vocab):
    """(vocab, D) float32 gradient of the table: row ``v`` is the sum of
    the error rows whose id is ``v``, as the reference's ``.at[ids].add``.
    Deterministic on every device and free of host syncs: a stable sort
    of the ids puts each id's rows together in the order they appear,
    ``searchsorted`` finds every id's segment (empty for unseen ids), and
    ``segment_reduce`` sums each segment in that order."""
    ids = ids.reshape(-1).long()
    rows = err.reshape(ids.shape[0], -1).to(torch.float32)
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(vocab + 1, device=ids.device))
    return torch.segment_reduce(rows[order], "sum", offsets=offsets,
                                unsafe=True)


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

    def shard_positions(self, offset, length):
        """Keep rows ``offset`` … ``offset + length`` of the positional
        table: this rank's positions under sequence parallelism."""
        if self.positions is not None:
            self.positions = self.positions[offset:offset + length]

    def forward(self, ids):
        y = self.weights[ids.long()]
        if self.positions is not None:
            y = y + self.positions
        return y.to(self.device.act_dtype)


@gradient_for(EmbeddingForward)
class GDEmbedding(GradientDescentBase):
    """Sum the error rows into the table's gradient
    (:func:`embedding_grad`); no err_input (ids are not
    differentiable)."""

    def __init__(self, need_err_input=False, **kwargs):
        super().__init__(need_err_input=need_err_input, **kwargs)

    def run(self, x, y, err):
        self.update_weights(
            embedding_grad(x, err, self.forward.vocab_size), None)
        return None
