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


def pool_shape(ishape, ky, kx, sliding):
    """(B, oy, ox, C) output of a ceil-mode pool over (B, H, W, C): the
    partial windows at the bottom and right edges are pooled."""
    b, h, w, c = ishape
    sy, sx = sliding
    return (b, -(-max(h - ky, 0) // sy) + 1, -(-max(w - kx, 0) // sx) + 1,
            c)


def pool_taps(x, ky, kx, sliding, pad_value):
    """-> [(t, (B, oy, ox, C) view)] of ``x`` padded with ``pad_value`` so
    that every ceil-mode window is full, in window order."""
    _, h, w, _ = x.shape
    _, oy, ox, _ = pool_shape(x.shape, ky, kx, sliding)
    sy, sx = sliding
    need_h, need_w = (oy - 1) * sy + ky, (ox - 1) * sx + kx
    x = CM.pad_nhwc(x, (0, need_h - h, 0, need_w - w), pad_value)
    return CM.window_taps(x, ky, kx, sliding, oy, ox)


def max_pool(x, ky, kx, sliding, pad_value=-float("inf"), key=None):
    """Running maximum of ``key(v)`` (``v`` itself by default) over the
    window taps of ``x`` -> (winner's value, (B, oy, ox, C) int32 winning
    tap); a later tap wins only when strictly greater."""
    best = sel = best_key = None
    for t, piece in pool_taps(x, ky, kx, sliding, pad_value):
        k = piece if key is None else key(piece)
        if best is None:
            best, best_key = piece, k
            sel = torch.zeros(piece.shape, dtype=torch.int32,
                              device=piece.device)
            continue
        better = k > best_key
        best = torch.where(better, piece, best)
        best_key = torch.where(better, k, best_key)
        sel.masked_fill_(better, t)
    return best, sel


def window_counts(ishape, ky, kx, sliding, device):
    """(oy, ox, 1) f32 count of the real cells in each window."""
    _, h, w, _ = ishape
    _, oy, ox, _ = pool_shape(ishape, ky, kx, sliding)
    sy, sx = sliding
    rows = [min(i * sy + ky, h) - i * sy for i in range(oy)]
    cols = [min(j * sx + kx, w) - j * sx for j in range(ox)]
    counts = torch.tensor(rows, dtype=torch.float32)[:, None] \
        * torch.tensor(cols, dtype=torch.float32)[None, :]
    return counts.clamp_min(1.0)[:, :, None].to(device)


def avg_pool(x, ky, kx, sliding):
    """Window sums of ``x`` tap after tap, over the true window size."""
    total = None
    for _, piece in pool_taps(x, ky, kx, sliding, 0.0):
        total = piece.clone() if total is None else total.add_(piece)
    return total / window_counts(x.shape, ky, kx, sliding, x.device)


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
        return pool_shape(ishape, self.ky, self.kx, self.sliding)

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
        """:func:`pool_taps` of ``x``, padded with ``pad_value`` (default
        ``PAD_VALUE``)."""
        return pool_taps(x, self.ky, self.kx, self.sliding,
                         self.PAD_VALUE if pad_value is None else pad_value)

    def patches(self, x):
        """(B, oy, ox, ky·kx, C) stack of the taps (stochastic pooling)."""
        return torch.stack([v for _, v in self.taps(x)], dim=3)

    def forward(self, x):
        return self.pool(x.to(torch.float32)).to(self.device.act_dtype)

    def pool(self, x):
        raise NotImplementedError


class MaxPoolingBase(PoolingBase):
    """Running maximum of ``key`` over the taps; the winner's value
    (sign kept) and offset."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        #: (B, oy, ox, C) int32 winning tap of the last forward
        self.input_offset = None

    #: the value compared (None: the value itself)
    key = None

    def pool(self, x):
        best, self.input_offset = max_pool(
            x, self.ky, self.kx, self.sliding, self.PAD_VALUE, self.key)
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
        return window_counts(ishape, self.ky, self.kx, self.sliding, device)

    def pool(self, x):
        return avg_pool(x, self.ky, self.kx, self.sliding)


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

    def get_state(self):
        """The generator's state (a checkpoint's ``units`` section), so a
        resumed run draws what an uninterrupted one would."""
        return {"generator": prng.generator_state(self.generator)}

    def set_state(self, state):
        prng.set_generator_state(self.generator, state["generator"])

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
