"""Multi-head attention, transformer FFN and per-token dense units of the
PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/attention.py``, each unit pair with
the reference's explicit forward/backward math (no autograd):

* ``TokenDense``/``TokenDenseRELU`` — ``act(x·W + b)`` over the last
  axis of (B, S, D);
* ``TransformerFFN`` — ``y = [x +] relu(x·W1 + b1)·W2 + b2`` with the
  extra parameters ``weights2``/``bias2``;
* ``MultiHeadAttention`` — causal (or full) self-attention with a fused
  qkv projection ``weights`` (D, 3D), an out-projection ``weights_out``
  (D, D) and an internal residual. Three modes of the reference's
  ``_traced_mode`` are ported: ``"dense"`` (the (B, H, S, S) score
  matrix, :func:`dense_attention_core_fwd`/``_bwd``), ``"scan"`` (the
  blocked scan of ``ops/scan_attention.py``) and ``"pallas"``, which
  keeps its config name and means the hand-written flash kernels
  (``ops/flash_attention.py``: the sm_90a kernels on the card, the plain
  version on the CPU). ``attn_block_size`` without ``attn_impl`` takes
  the kernels on the card from ``PALLAS_AUTO_MIN_S`` on, the scan
  otherwise. With ``seq_mesh`` set (``parallel.setup_sequence_parallel``)
  the unit works on its rank's ``S/n`` positions and the fourth mode,
  ``"ring"``, runs attention round the ``seq`` axis
  (``parallel/ring.py``; its inner block by the reference's
  ``_ring_inner`` policy, on the PER-SHARD length).

Megatron tensor parallelism (``parallel.setup_tensor_parallel``: a unit's
``tp_mesh`` set): an attention unit keeps ``heads/n`` heads (its q, k and
v columns of ``weights``/``bias``, its rows of ``weights_out``), an FFN
``hidden/n`` units (columns of ``weights``/``bias``, rows of
``weights2``); the partial sums of the row-sharded product are
all-reduced over the ``model`` axis before the replicated ``bias_out`` /
``bias2`` and the residual are added once, and the backward all-reduces
the partial input gradient the same way.

The projections around the kernels are ``torch.matmul`` through
``TorchDevice.dot``, as the reference leaves them to XLA. Every bias
gradient is a column sum through ``ops/bias_grad.bias_grad``.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops import flash_attention as FA
from veles_torch.znicz.ops import scan_attention as SA
from veles_torch.znicz.ops.bias_grad import bias_grad
from veles_torch.znicz.parallel import collectives as C
from veles_torch.znicz.parallel import ring as R


def rows(t):
    """(..., K) -> contiguous (N, K)."""
    return t.reshape(-1, t.shape[-1]).contiguous()


def column_sum(t):
    """f32 sum over every leading dim (the identity form of the
    bias-gradient kernel)."""
    t2 = rows(t)
    return bias_grad(t2, t2, "linear")


def tp_sum(unit, t):
    """``t`` summed over the unit's ``model`` axis under TP (a row-sharded
    product's partial sums), else ``t``."""
    if getattr(unit, "tp_mesh", None) is None:
        return t
    return C.all_reduce(t, unit.tp_mesh, unit.tp_axis)


def _pow2_divisor(s, cap):
    """Largest power-of-two divisor of ``s``, at most ``cap``."""
    b = 1
    while b * 2 <= cap and s % (b * 2) == 0:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# per-token dense (operates on the trailing dim of (B, S, D))


class TokenDenseBase(Forward):
    """y = act(x · W + b) over the last axis, any leading shape."""

    ACTIVATION = "linear"

    def __init__(self, output_features=None, **kwargs):
        super().__init__(**kwargs)
        if not output_features:
            raise ValueError("token_dense needs output_features")
        self.output_features = int(output_features)

    def initialize(self, input_shape, device):
        self.device = device
        d = input_shape[-1]
        self.init_weights((d, self.output_features), d,
                          self.output_features)
        return tuple(input_shape[:-1]) + (self.output_features,)

    def forward(self, x):
        v = self.device.dot(x, self.weights)
        if self.include_bias:
            v = v + self.bias
        return A.ACTIVATIONS[self.ACTIVATION][0](v).to(
            self.device.act_dtype)


@forward_unit("token_dense")
class TokenDense(TokenDenseBase):
    ACTIVATION = "linear"


@forward_unit("token_dense_relu")
class TokenDenseRELU(TokenDenseBase):
    ACTIVATION = "strict_relu"


class GDTokenDenseBase(GradientDescentBase):
    ACTIVATION = "linear"

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        err = err.reshape(y.shape)
        d = A.ACTIVATIONS[self.ACTIVATION][1](y)
        dz = err if isinstance(d, float) else err * d
        grad_w = dev.dot(rows(x).t(), rows(dz))
        grad_b = bias_grad(rows(err), rows(y), self.ACTIVATION) \
            if f.include_bias else None
        dx = dev.dot(dz, f.weights.t()).to(dev.act_dtype) \
            if self.need_err_input else None
        self.update_weights(grad_w, grad_b)
        return dx


@gradient_for(TokenDense)
class GDTokenDense(GDTokenDenseBase):
    ACTIVATION = "linear"


@gradient_for(TokenDenseRELU)
class GDTokenDenseRELU(GDTokenDenseBase):
    ACTIVATION = "strict_relu"


# ---------------------------------------------------------------------------
# transformer FFN block: y = [x +] act(x·W1+b1)·W2+b2


@forward_unit("transformer_ffn")
class TransformerFFN(Forward):
    PARAMS = ("weights", "bias", "weights2", "bias2")
    ACTIVATION = "strict_relu"

    def __init__(self, hidden=None, residual=True, **kwargs):
        super().__init__(**kwargs)
        self.hidden = hidden
        self.residual = residual
        #: f32 hidden activation of the last forward (the GD's input)
        self.cache_h = None
        #: the mesh and axis of Megatron TP, or None
        self.tp_mesh = None
        self.tp_axis = "model"

    def initialize(self, input_shape, device):
        self.device = device
        d = input_shape[-1]
        self.hidden = self.hidden or 4 * d
        self.init_weights((d, self.hidden), d, self.hidden)
        w2 = numpy.zeros((self.hidden, d), numpy.float32)
        self.fill_array(w2, self.weights_filling,
                        self.weights_stddev
                        or self.default_weights_stddev(self.hidden, d))
        self.weights2 = torch.as_tensor(w2).to(device.device)
        self.bias2 = torch.zeros(d, dtype=torch.float32,
                                 device=device.device)
        return tuple(input_shape)

    def forward(self, x):
        dot = self.device.dot
        hcur = A.ACTIVATIONS[self.ACTIVATION][0](
            dot(x, self.weights) + self.bias)
        y = tp_sum(self, dot(hcur, self.weights2)) + self.bias2
        if self.residual:
            y = y + x
        self.cache_h = hcur
        return y.to(self.device.act_dtype)


@gradient_for(TransformerFFN)
class GDTransformerFFN(GradientDescentBase):
    EXTRA_PARAMS = (("weights2", False), ("bias2", True))

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        dot = dev.dot
        err = err.reshape(x.shape)
        hcur = f.cache_h
        dh = dot(err, f.weights2.t()) \
            * A.ACTIVATIONS[f.ACTIVATION][1](hcur)
        gw2 = dot(rows(hcur).t(), rows(err))
        gb2 = column_sum(err)
        gw1 = dot(rows(x).t(), rows(dh))
        gb1 = column_sum(dh)
        dx = None
        if self.need_err_input:
            dx = tp_sum(f, dot(dh, f.weights.t()))
            if f.residual:
                dx = dx + err
            dx = dx.to(dev.act_dtype)
        self.update_weights(gw1, gb1)
        self.update_extra({"weights2": gw2, "bias2": gb2})
        return dx


# ---------------------------------------------------------------------------
# multi-head attention


def dense_attention_core_fwd(q, k, v, causal, scale, dot=torch.matmul):
    """(probs, ctx) with ctx = softmax(q·kᵀ·scale [+ causal mask])·v over
    (B, H, S, dh)."""
    s = q.shape[2]
    scores = dot(q, k.transpose(-1, -2)) * scale
    if causal:
        scores = scores + torch.triu(torch.full(
            (s, s), FA.MASK_VALUE, dtype=torch.float32,
            device=scores.device), 1)
    probs = A.softmax(scores)
    return probs, dot(probs, v)


def dense_attention_core_bwd(q, k, v, probs, dctx, scale, dot=torch.matmul):
    """Backward of the core: (dq, dk, dv). Masked probs are exactly zero,
    so the mask needs no re-application."""
    dprobs = dot(dctx, v.transpose(-1, -2))
    dv = dot(probs.transpose(-1, -2), dctx)
    dscores = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True))
    dscores = dscores * scale
    return dot(dscores, k), dot(dscores.transpose(-1, -2), q), dv


@forward_unit("attention")
class MultiHeadAttention(Forward):
    """Causal (or full) multi-head self-attention over (B, S, D) with an
    optional internal residual (y = x + attn(x)).

    Config knobs shared with the reference: ``attn_impl`` (None, "scan",
    "pallas"), ``attn_block_size``, ``pallas_tile``, ``attn_pipeline``
    (``_fwd_kernel_pipe``'s counterpart, the mask on every tile) and
    ``attn_acc``
    (None/"f32", or "bf16": the narrowed PV accumulation)."""

    PARAMS = ("weights", "bias", "weights_out", "bias_out")

    def __init__(self, heads=4, causal=True, residual=True,
                 attn_block_size=None, attn_impl=None, pallas_tile=None,
                 attn_pipeline=False, attn_acc=None, **kwargs):
        super().__init__(**kwargs)
        self.heads = int(heads)
        self.causal = causal
        self.residual = residual
        self.attn_block_size = attn_block_size
        self.attn_impl = attn_impl
        if attn_impl not in (None, "scan", "pallas"):
            raise ValueError("attn_impl must be None, 'scan' or 'pallas', "
                             "got %r" % (attn_impl,))
        self.pallas_tile = pallas_tile
        self.attn_pipeline = bool(attn_pipeline)
        self.attn_acc = attn_acc
        if attn_acc not in (None, "f32", "bf16"):
            raise ValueError("attn_acc must be None, 'f32' or 'bf16', "
                             "got %r" % (attn_acc,))
        #: the forward's cache for the GD unit: (q, k, v, out_heads, lse,
        #: merged) in the "ring", "pallas" and "scan" modes, (q, k, v,
        #: probs, merged) dense
        self.cache = None
        #: sequence parallelism: the mesh whose ``seq_axis`` the ring runs
        #: round (``parallel.setup_sequence_parallel``), or None
        self.seq_mesh = None
        self.seq_axis = "seq"
        self.seq_batch_axis = None
        #: the mesh and axis of Megatron TP, or None
        self.tp_mesh = None
        self.tp_axis = "model"
        #: the head width, set by initialize
        self.head_dim = None

    #: the auto policy: with ``attn_block_size`` set and ``attn_impl``
    #: None, the flash kernels take over on the card once S reaches this
    #: bound, the scan runs below it and everywhere on the CPU (the
    #: reference's ``PALLAS_AUTO_MIN_S``, 1024, was measured on a TPU).
    #: ``chip_smoke.py`` phase ``attn_policy`` timed the 110M train step by
    #: the host clock, scan (block 256) against the kernels, on an NVIDIA
    #: H100 80GB HBM3 at 700 W: S 512 (B 8) 106.6 vs 67.0 ms, S 1024 178.6
    #: vs 71.7, S 2048 373.4 vs 100.0, S 8192 (B 4) 2379.7 vs 226.7. The
    #: kernels win from the smallest S measured on
    PALLAS_AUTO_MIN_S = 512

    def mode(self, s):
        """The reference's dispatch resolver (``_traced_mode``) for a
        single-device sequence of length ``s``: "pallas" (the flash
        kernels), "scan" (the blocked scan) or "dense". The experiment
        knobs are refused off the pallas mode, and ``pallas_tile`` (a TPU
        tile override) on it."""
        on_card = self.device is not None and self.device.platform == "cuda"
        if self.seq_mesh is not None:
            mode = "ring"
        elif self.attn_impl == "pallas":
            mode = "pallas"
        elif not self.attn_block_size:
            mode = "dense"
        elif self.attn_impl is None and on_card \
                and s >= self.PALLAS_AUTO_MIN_S:
            mode = "pallas"
        else:
            mode = "scan"
        if mode != "pallas" and (self.attn_pipeline
                                 or self.attn_acc == "bf16"):
            raise ValueError(
                "attn_pipeline=%r / attn_acc=%r are only honoured on the "
                "single-shard pallas forward, but this dispatch resolves "
                "to %r (S=%d) — force attn_impl='pallas' or clear the "
                "knob" % (self.attn_pipeline, self.attn_acc, mode, s))
        if mode in ("pallas", "ring") and self.pallas_tile is not None:
            raise NotImplementedError(
                "%s: pallas_tile=%r is a TPU tile override; the port's "
                "kernels choose their own tiles (ROADMAP Queue 1 item 8)"
                % (self.name, self.pallas_tile))
        return mode

    def ring_inner(self):
        """(inner, block) of the ring's local blocks, the reference's
        ``_ring_inner`` policy on the PER-SHARD length: an explicit
        ``attn_impl`` wins; with none, the kernels on the card once the
        shard reaches ``PALLAS_AUTO_MIN_S``; a set ``attn_block_size``
        routes the block through the scan (its tile when it divides the
        shard, else the largest power-of-two divisor up to 128);
        otherwise the fused dense block, (None, None)."""
        s_loc = self.input_shape[1] // self.seq_mesh.shape[self.seq_axis]
        on_card = self.device is not None and self.device.platform == "cuda"
        if self.attn_impl == "pallas":
            inner = "pallas"
        elif self.attn_impl == "scan":
            inner = "scan"
        elif self.attn_impl is None and s_loc >= self.PALLAS_AUTO_MIN_S \
                and on_card:
            inner = "pallas"
        elif self.attn_block_size:
            inner = "scan"
        else:
            return None, None
        if inner == "pallas":
            return inner, None     # the kernels choose their own tiles
        if self.attn_block_size and s_loc % self.attn_block_size == 0:
            return inner, self.attn_block_size
        return inner, _pow2_divisor(s_loc, 128)

    def initialize(self, input_shape, device):
        self.device = device
        _, s, d = input_shape
        if d % self.heads:
            raise ValueError("dim %d not divisible by %d heads"
                             % (d, self.heads))
        self.mode(s)
        self.head_dim = d // self.heads
        self.init_weights((d, 3 * d), d, 3 * d)
        wo = numpy.zeros((d, d), numpy.float32)
        self.fill_array(wo, self.weights_filling,
                        self.weights_stddev
                        or self.default_weights_stddev(d, d))
        self.weights_out = torch.as_tensor(wo).to(device.device)
        if self.include_bias:
            self.bias_out = torch.zeros(d, dtype=torch.float32,
                                        device=device.device)
        return tuple(input_shape)

    def split(self, t):
        """(B, S, h·dh) -> (B, h, S, dh): every head of the unit, or its
        rank's heads under TP."""
        b, s, _ = t.shape
        return t.reshape(b, s, -1, self.head_dim).transpose(1, 2)

    def merge(self, t):
        b, h, s, dh = t.shape
        return t.transpose(1, 2).reshape(b, s, h * dh)

    def scale(self, d):
        return FA.scale_for(d // self.heads)

    def project_qkv(self, x):
        qkv = self.device.dot(x, self.weights)
        if self.include_bias:
            qkv = qkv + self.bias
        w = qkv.shape[-1] // 3     # D, or D/n under TP
        return (self.split(qkv[..., :w]), self.split(qkv[..., w:2 * w]),
                self.split(qkv[..., 2 * w:]))

    def finish(self, x, merged):
        y = tp_sum(self, self.device.dot(merged, self.weights_out))
        if self.include_bias:
            y = y + self.bias_out
        if self.residual:
            y = y + x
        return y.to(self.device.act_dtype)

    def forward(self, x):
        q, k, v = self.project_qkv(x)
        mode = self.mode(x.shape[1])
        if mode == "ring":
            inner, block = self.ring_inner()
            if inner is not None:
                cd = self.device.compute_dtype
                q, k, v = (t.to(cd).contiguous() for t in (q, k, v))
            out_heads, lse = R.ring_self_attention(
                q, k, v, self.seq_mesh, axis=self.seq_axis,
                causal=self.causal, batch_axis=self.seq_batch_axis,
                inner=inner, block=block, dot=self.device.dot)
            merged = self.merge(out_heads)
            self.cache = (q, k, v, out_heads, lse, merged)
        elif mode in ("pallas", "scan"):
            # q/k/v in the compute dtype (bf16 on the card): matched
            # kernel inputs and half the cache
            cd = self.device.compute_dtype
            q, k, v = (t.to(cd).contiguous() for t in (q, k, v))
            if mode == "pallas":
                out_heads, lse = FA.flash_attention_fwd(
                    q, k, v, causal=self.causal,
                    pipeline=self.attn_pipeline,
                    acc_dtype=torch.bfloat16 if self.attn_acc == "bf16"
                    else None)
            else:
                out_heads, lse = SA.blocked_attention_fwd(
                    q, k, v, causal=self.causal,
                    block=self.attn_block_size, dot=self.device.dot)
            merged = self.merge(out_heads)
            self.cache = (q, k, v, out_heads, lse, merged)
        else:
            probs, ctx = dense_attention_core_fwd(
                q, k, v, self.causal, self.scale(x.shape[-1]),
                self.device.dot)
            merged = self.merge(ctx)
            self.cache = (q, k, v, probs, merged)
        return self.finish(x, merged)


@gradient_for(MultiHeadAttention)
class GDMultiHeadAttention(GradientDescentBase):
    """Hand-written attention backward: the output projection, the
    attention core (the fused flash backward kernel in the "pallas" mode,
    the dense formula otherwise), the qkv projection and the residual."""

    EXTRA_PARAMS = (("weights_out", False), ("bias_out", True))

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        dot = dev.dot
        d = x.shape[-1]
        err = err.reshape(x.shape)
        *qkv, merged = f.cache
        gwo = dot(rows(merged).t(), rows(err))
        gbo = column_sum(err) if f.include_bias else None
        dctx = f.split(dot(err, f.weights_out.t()))
        mode = f.mode(x.shape[1])
        if mode == "ring":
            q, k, v, out_heads, lse = qkv
            inner, block = f.ring_inner()
            if inner is not None:
                dctx = dctx.to(dev.compute_dtype).contiguous()
            dq, dk, dv = R.ring_self_attention_bwd(
                q, k, v, out_heads, lse, dctx, f.seq_mesh,
                axis=f.seq_axis, causal=f.causal,
                batch_axis=f.seq_batch_axis, inner=inner, block=block,
                dot=dot)
        elif mode == "pallas":
            q, k, v, out_heads, lse = qkv
            dq, dk, dv = FA.flash_attention_bwd(
                q, k, v, out_heads, lse,
                dctx.to(dev.compute_dtype).contiguous(), causal=f.causal)
        elif mode == "scan":
            q, k, v, out_heads, lse = qkv
            dq, dk, dv = SA.blocked_attention_bwd(
                q, k, v, out_heads, lse, dctx.to(dev.compute_dtype),
                causal=f.causal, block=f.attn_block_size, dot=dot)
        else:
            q, k, v, probs = qkv
            dq, dk, dv = dense_attention_core_bwd(
                q, k, v, probs, dctx, f.scale(d), dot)
        dqkv = torch.cat([f.merge(dq), f.merge(dk), f.merge(dv)], dim=-1)
        gw = dot(rows(x).t(), rows(dqkv))
        gb = column_sum(dqkv) if f.include_bias else None
        dx = None
        if self.need_err_input:
            dx = tp_sum(f, dot(dqkv, f.weights.t()))
            if f.residual:
                dx = dx + err
            dx = dx.to(dev.act_dtype)
        self.update_weights(gw, gb)
        self.update_extra({"weights_out": gwo, "bias_out": gbo})
        return dx
