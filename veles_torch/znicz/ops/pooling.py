"""Pooling forward units of the port.

Counterpart of ``veles/znicz_tpu/ops/pooling.py``: max, max-abs, average
and stochastic pooling over ky×kx windows with stride ``sliding``, NHWC,
with the reference's rules:

* ceil-mode edges: partial windows at the bottom and right are pooled
  (``output_shape_for``/``padded_hw``, the one definition of the edge
  geometry, shared with the backward);
* max variants record the winning in-window offset (``input_offset``,
  window order p·kx + q) for the backward; the first maximum in window
  order wins ties, as the reference's argmax does;
* the average divides by the true (unpadded) window size.

Max, max-abs and average walk the window's taps (strided views of the
input, ``conv_math.window_taps``) and keep a running result, so no
(B, oy, ox, ky·kx, C) patch tensor is made; a later tap replaces the
running maximum only when strictly greater, which is the first-wins
rule. They compute in f32 and store the output in ``act_dtype``.
Stochastic pooling draws its uniforms from an explicit
``torch.Generator`` (``prng.torch_generator``, one per unit); the
reference's ``jax.random`` bits cannot be reproduced, so its parity is
tested with the uniforms injected (:meth:`StochasticPooling.uniform`).
In eval mode (``.eval()``) it takes the probability-weighted average.
"""

import torch

from veles_torch import prng
from veles_torch.znicz.nn_units import Forward, forward_unit
from veles_torch.znicz.ops import conv_math as CM


class PoolingBase(Forward):
    """Window-reduce over NHWC input. No weights."""

    PARAMS = ()
    #: value of the cells past the bottom/right edge (it never wins)
    PAD_VALUE = 0.0

    def __init__(self, kx=2, ky=2, sliding=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)
        if isinstance(sliding, int):
            sliding = (sliding, sliding)
        self.sliding = tuple(int(s) for s in sliding)

    def output_shape_for(self, ishape):
        b, h, w, c = ishape
        sy, sx = self.sliding
        oy = -(-max(h - self.ky, 0) // sy) + 1
        ox = -(-max(w - self.kx, 0) // sx) + 1
        return (b, oy, ox, c)

    def padded_hw(self, ishape):
        """(need_h, need_w): the input extent padded so that every
        ceil-mode window is full."""
        _, oy, ox, _ = self.output_shape_for(ishape)
        sy, sx = self.sliding
        return ((oy - 1) * sy + self.ky, (ox - 1) * sx + self.kx)

    def initialize(self, input_shape, device):
        self.device = device
        return self.output_shape_for(input_shape)

    def taps(self, x, pad_value=None):
        """-> [(t, (B, oy, ox, C) view)] of ``x`` padded to
        :meth:`padded_hw` with ``pad_value``, in window order."""
        _, h, w, _ = x.shape
        _, oy, ox, _ = self.output_shape_for(x.shape)
        need_h, need_w = self.padded_hw(x.shape)
        x = CM.pad_nhwc(x, (0, need_h - h, 0, need_w - w),
                        self.PAD_VALUE if pad_value is None else pad_value)
        return CM.window_taps(x, self.ky, self.kx, self.sliding, oy, ox)

    def patches(self, x):
        """(B, oy, ox, ky·kx, C) stack of the taps (stochastic pooling)."""
        return torch.stack([v for _, v in self.taps(x)], dim=3)

    def forward(self, x):
        return self.pool(x.to(torch.float32)).to(self.device.act_dtype)

    def pool(self, x):
        raise NotImplementedError


class MaxPoolingBase(PoolingBase):
    """Running maximum of :meth:`key` over the taps; the winner's value
    (sign kept) and offset."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        #: (B, oy, ox, C) int32 winning tap of the last forward
        self.input_offset = None

    @staticmethod
    def key(v):
        return v

    def pool(self, x):
        best = sel = best_key = None
        for t, piece in self.taps(x):
            if best is None:
                best, best_key = piece, self.key(piece)
                sel = torch.zeros(piece.shape, dtype=torch.int32,
                                  device=piece.device)
                continue
            k = self.key(piece)
            better = k > best_key
            best = torch.where(better, piece, best)
            best_key = torch.where(better, k, best_key)
            sel.masked_fill_(better, t)
        self.input_offset = sel
        return best


@forward_unit("max_pooling")
class MaxPooling(MaxPoolingBase):
    PAD_VALUE = -float("inf")


@forward_unit("maxabs_pooling")
class MaxAbsPooling(MaxPoolingBase):
    """Propagates the element with the largest |value| (sign kept)."""

    key = staticmethod(torch.abs)


@forward_unit("avg_pooling")
class AvgPooling(PoolingBase):
    def window_counts(self, ishape, device):
        """(oy, ox, 1) f32 count of the real cells in each window."""
        _, h, w, _ = ishape
        _, oy, ox, _ = self.output_shape_for(ishape)
        sy, sx = self.sliding
        rows = [min(i * sy + self.ky, h) - i * sy for i in range(oy)]
        cols = [min(j * sx + self.kx, w) - j * sx for j in range(ox)]
        counts = torch.tensor(rows, dtype=torch.float32)[:, None] \
            * torch.tensor(cols, dtype=torch.float32)[None, :]
        return counts.clamp_min(1.0)[:, :, None].to(device)

    def pool(self, x):
        total = None
        for _, piece in self.taps(x):
            total = piece.clone() if total is None else total.add_(piece)
        return total / self.window_counts(x.shape, x.device)


@forward_unit("stochastic_pooling")
class StochasticPooling(PoolingBase):
    """Training: sample the window element with probability ∝ its value
    (negatives count 0; a window of no positive value is uniform); eval:
    the probability-weighted average."""

    def __init__(self, prng_key="stochastic_pool", **kwargs):
        super().__init__(**kwargs)
        self.prng_key = prng_key
        self.generator = None
        self.input_offset = None

    def initialize(self, input_shape, device):
        self.generator = prng.torch_generator(
            "%s/%s" % (self.prng_key, self.name), device.device)
        return super().initialize(input_shape, device)

    def uniform(self, shape, device):
        """The (B, oy, ox, C) uniforms of one train forward."""
        return torch.rand(shape, generator=self.generator, device=device)

    @staticmethod
    def probs(patches):
        p = patches.clamp_min(0.0)
        total = p.sum(dim=3, keepdim=True)
        return torch.where(total > 0, p / total.clamp_min(1e-30),
                           1.0 / patches.shape[3])

    def pool(self, x):
        patches = self.patches(x)
        probs = self.probs(patches)
        if not self.training:
            return (patches * probs).sum(dim=3)
        u = self.uniform(patches.shape[:3] + patches.shape[4:], x.device)
        cum = torch.cumsum(probs, dim=3)
        sel = (cum < u[:, :, :, None, :]).sum(dim=3) \
            .clamp(0, patches.shape[3] - 1)
        self.input_offset = sel.to(torch.int32)
        return torch.gather(patches, 3, sel[:, :, :, None, :]).squeeze(3)
