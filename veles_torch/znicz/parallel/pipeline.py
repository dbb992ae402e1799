"""The stacked transformer block's math, single-program part.

Counterpart of the single-program half of
``veles/znicz_tpu/parallel/pipeline.py`` (the port's own copy):

* :func:`block_fwd` / :func:`block_bwd` — one post-LN transformer block
  (MHA + residual -> LN -> FFN + residual -> LN) and its hand-written
  backward, on the attention and layernorm formulas the per-layer units
  use;
* :func:`stack_fwd` / :func:`stack_bwd` — the block over stacked
  ``(L, ...)`` parameters: a Python loop over L (the reference's
  ``lax.scan``), every layer's cache kept;
* :func:`stack_fwd_remat` / :func:`stack_bwd_remat` — the same keeping
  only each layer's INPUT; the backward recomputes a layer's cache from
  it just before that layer's backward. The recomputation runs the same
  operations on the same values, so the result is bit for bit the
  non-remat one.

``dot`` is the matmul (the device's ``dot``: compute-dtype inputs, f32
sums). The bias sums go through ``ops/bias_grad.bias_grad``, as the
per-layer units' do (its identity form: the kernel on the card). The GPipe
and 1F1B schedules across devices are ROADMAP Queue 1 item 10c.
"""

import torch

from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops.attention import (
    column_sum, dense_attention_core_bwd, dense_attention_core_fwd, rows)
from veles_torch.znicz.ops.flash_attention import scale_for
from veles_torch.znicz.ops.layernorm import ln_bwd, ln_fwd

#: per-block stashed activations, in block_fwd production order
CACHE_KEYS = ("x", "q", "k", "v", "probs", "merged", "a", "n1", "h", "fo")
#: the blocks' parameters, stacked along L (the unit's PARAMS)
PARAMS = ("weights", "bias", "weights_out", "bias_out", "ln1_g", "ln1_b",
          "ffn_w1", "ffn_b1", "ffn_w2", "ffn_b2", "ln2_g", "ln2_b")

ACT = "strict_relu"


def _split(t, heads):
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


def _merge(t):
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def _wgrad(a, b, dot):
    """Σ over (B, S) of a ⊗ b: the einsum ``bsd,bse->de``."""
    return dot(rows(a).t(), rows(b))


def block_fwd(x, lp, heads, causal, eps, dot=torch.matmul):
    """One block on f32 ``x`` (B, S, D) with the layer's params ``lp``
    -> (y, cache)."""
    d = x.shape[-1]
    qkv = dot(x, lp["weights"]) + lp["bias"]
    q = _split(qkv[..., :d], heads)
    k = _split(qkv[..., d:2 * d], heads)
    v = _split(qkv[..., 2 * d:], heads)
    probs, ctx = dense_attention_core_fwd(q, k, v, causal,
                                          scale_for(d // heads), dot)
    merged = _merge(ctx)
    a = dot(merged, lp["weights_out"]) + lp["bias_out"] + x
    n1 = ln_fwd(a, lp["ln1_g"], lp["ln1_b"], eps)
    h = A.ACTIVATIONS[ACT][0](dot(n1, lp["ffn_w1"]) + lp["ffn_b1"])
    fo = dot(h, lp["ffn_w2"]) + lp["ffn_b2"] + n1
    y = ln_fwd(fo, lp["ln2_g"], lp["ln2_b"], eps)
    return y, dict(zip(CACHE_KEYS, (x, q, k, v, probs, merged, a, n1, h,
                                    fo)))


def block_bwd(lp, cache, err, heads, eps, dot=torch.matmul):
    """Backward of :func:`block_fwd` for f32 ``err`` -> (dx, grads keyed
    like ``lp``)."""
    x, q, k, v, probs, merged, a, n1, h, fo = (cache[key]
                                               for key in CACHE_KEYS)
    d = x.shape[-1]
    dfo, g_ln2g, g_ln2b = ln_bwd(fo, lp["ln2_g"], err, eps)
    dhid = dot(dfo, lp["ffn_w2"].t()) * A.ACTIVATIONS[ACT][1](h)
    g_w2 = _wgrad(h, dfo, dot)
    g_b2 = column_sum(dfo)
    g_w1 = _wgrad(n1, dhid, dot)
    g_b1 = column_sum(dhid)
    dn1 = dot(dhid, lp["ffn_w1"].t()) + dfo
    da, g_ln1g, g_ln1b = ln_bwd(a, lp["ln1_g"], dn1, eps)
    g_wo = _wgrad(merged, da, dot)
    g_bo = column_sum(da)
    dctx = _split(dot(da, lp["weights_out"].t()), heads)
    dq, dk, dv = dense_attention_core_bwd(q, k, v, probs, dctx,
                                          scale_for(d // heads), dot)
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    g_w = _wgrad(x, dqkv, dot)
    g_b = column_sum(dqkv)
    dx = dot(dqkv, lp["weights"].t()) + da
    return dx, {"weights": g_w, "bias": g_b, "weights_out": g_wo,
                "bias_out": g_bo, "ln1_g": g_ln1g, "ln1_b": g_ln1b,
                "ffn_w1": g_w1, "ffn_b1": g_b1, "ffn_w2": g_w2,
                "ffn_b2": g_b2, "ln2_g": g_ln2g, "ln2_b": g_ln2b}


def layer_params(params, i):
    """Layer ``i``'s dict of the stacked ``params``."""
    return {key: value[i] for key, value in params.items()}


def _stacked(per_layer):
    """[{key: tensor} per layer] -> {key: (L, ...) tensor}."""
    return {key: torch.stack([g[key] for g in per_layer])
            for key in per_layer[0]}


def stack_fwd(params, x, heads, causal, eps, dot=torch.matmul):
    """The block over every layer of ``params`` -> (y, [cache per
    layer])."""
    caches = []
    for i in range(len(params["weights"])):
        x, cache = block_fwd(x, layer_params(params, i), heads, causal, eps,
                             dot)
        caches.append(cache)
    return x, caches


def stack_bwd(params, caches, err, heads, eps, dot=torch.matmul):
    """Backward of :func:`stack_fwd`, last layer first -> (dx, grads
    stacked along L)."""
    grads = [None] * len(caches)
    for i in reversed(range(len(caches))):
        err, grads[i] = block_bwd(layer_params(params, i), caches[i], err,
                                  heads, eps, dot)
    return err, _stacked(grads)


def stack_fwd_remat(params, x, heads, causal, eps, dot=torch.matmul):
    """Like :func:`stack_fwd`, keeping only each layer's input -> (y,
    [input per layer])."""
    xs = []
    for i in range(len(params["weights"])):
        xs.append(x)
        x, _ = block_fwd(x, layer_params(params, i), heads, causal, eps,
                         dot)
    return x, xs


def stack_bwd_remat(params, xs, err, heads, causal, eps, dot=torch.matmul):
    """Backward of :func:`stack_fwd_remat`: each layer's cache recomputed
    from its stashed input, then :func:`block_bwd`."""
    grads = [None] * len(xs)
    for i in reversed(range(len(xs))):
        lp = layer_params(params, i)
        _, cache = block_fwd(xs[i], lp, heads, causal, eps, dot)
        err, grads[i] = block_bwd(lp, cache, err, heads, eps, dot)
    return err, _stacked(grads)
