"""The stacked transformer block's math and the pipeline schedules.

Counterpart of ``veles/znicz_tpu/parallel/pipeline.py`` (the port's own
copy):

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

* :func:`pipeline_fwd` / :func:`pipeline_bwd` — GPipe over a ``pipe``
  axis: the rank of stage ``s`` owns ``L/P`` consecutive blocks (its
  shard of the stacked parameters); microbatch ``m`` runs on stage ``s``
  at tick ``m + s`` forward and at tick ``m + P − 1 − s`` backward, its
  activations (and error) hopping to the next (previous) stage between
  ticks; the forward stashes every microbatch's caches;
* :func:`build_1f1b_schedule` — the static 1F1B (PipeDream-flush)
  schedule, host-side numpy, the reference's as it is;
* :func:`pipeline_1f1b_step` — the forwards and backwards interleaved by
  that schedule, the last stage turning each finished forward into its
  error at once (``err_fn``); a stage stashes at most ``min(M, P − s)``
  microbatches' caches where GPipe stashes ``M``.

The reference runs every stage every tick under ``shard_map`` and
permutes zeros where nothing is due; here each rank runs only its due
work, and each tick posts exactly the hops the static schedule gives it,
both sides of each hop in the same tick (:func:`stage_hop`, one
``batch_isend_irecv``): no hop that nobody reads. The reference's
``psum`` of the last stage's outputs and of stage 0's input gradient is
an all-reduce over ``pipe`` (zeros on the other stages); the parameter
gradients stay on their stage (the step sums them over ``data``), and the
weights never move. :data:`counts` counts each stage's chunk forwards
and backwards (one microbatch through its blocks).

``dot`` is the matmul (the device's ``dot``: compute-dtype inputs, f32
sums). The bias sums go through ``ops/bias_grad.bias_grad``, as the
per-layer units' do (its identity form: the kernel on the card).
"""

import collections

import numpy
import torch

from veles_torch.znicz.parallel import collectives as C

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


# ---------------------------------------------------------------------------
# the schedules over a pipe axis

#: {"forward": chunk forwards, "backward": chunk backwards} run by this
#: process's schedules (one microbatch through a stage's blocks)
counts = collections.Counter()


def stage_hop(mesh, axis, sends, recvs):
    """One tick's hops of this stage: ``sends`` [(shift, tensor,
    microbatch)], ``recvs`` [(shift, shape, dtype, device, microbatch)]
    -> the received tensors (``collectives.hop``)."""
    return C.hop(mesh, axis, [(sh, t) for sh, t, _ in sends],
                 [r[:4] for r in recvs])


def _stage(mesh, axis):
    return mesh.shape[axis], mesh.index(axis)


def _gsum(acc, grads):
    if acc is None:
        return grads
    return {key: acc[key] + grads[key] for key in acc}


def _psum_stage(t, keep, mesh, axis):
    """The reference's ``psum`` over the axis of a value only one stage
    holds (``keep``): -> every stage's copy of it."""
    return C.all_reduce(t if keep else torch.zeros_like(t), mesh, axis)


def pipeline_fwd(params, x, mesh, axis="pipe", n_micro=4, heads=4,
                 causal=True, eps=1e-5, dot=torch.matmul, stash=True):
    """GPipe forward of this rank's f32 rows ``x`` (b, S, D) over the
    stage's blocks ``params`` (leaves (L/P, ...)) -> (y on every stage,
    the stage's caches by microbatch, or None with ``stash=False``)."""
    n_stage, me = _stage(mesh, axis)
    b = x.shape[0]
    bm = b // n_micro
    shape = (bm,) + tuple(x.shape[1:])
    xs = x.reshape((n_micro,) + shape)
    last = me == n_stage - 1
    outs = torch.zeros((n_micro,) + shape, dtype=torch.float32,
                       device=x.device)
    caches = [None] * n_micro if stash else None
    recv = None
    for t in range(n_micro + n_stage - 1):
        m = t - me
        sends = []
        if 0 <= m < n_micro:
            y, cache = stack_fwd(params, xs[m] if me == 0 else recv, heads,
                                 causal, eps, dot)
            counts["forward"] += 1
            if stash:
                caches[m] = cache
            if last:
                outs[m] = y
            else:
                sends.append((1, y, m))
        prev = t - (me - 1)
        recvs = [(-1, shape, torch.float32, x.device, prev)] \
            if me > 0 and 0 <= prev < n_micro else []
        got = stage_hop(mesh, axis, sends, recvs)
        recv = got[0] if recvs else None
    y = _psum_stage(outs, last, mesh, axis).reshape(x.shape)
    return y, caches


def pipeline_bwd(params, caches, err, mesh, axis="pipe", n_micro=4,
                 heads=4, eps=1e-5, dot=torch.matmul):
    """GPipe backward: the error microbatches flow from the last stage to
    the first, each stage consuming its stashed caches -> (dx on every
    stage, the stage's parameter gradients summed over the
    microbatches)."""
    n_stage, me = _stage(mesh, axis)
    b = err.shape[0]
    bm = b // n_micro
    shape = (bm,) + tuple(err.shape[1:])
    es = err.reshape((n_micro,) + shape)
    dxs = torch.zeros((n_micro,) + shape, dtype=torch.float32,
                      device=err.device)
    grads, recv = None, None
    for t in range(n_micro + n_stage - 1):
        m = t - (n_stage - 1 - me)
        sends = []
        if 0 <= m < n_micro:
            din = es[m] if me == n_stage - 1 else recv
            dx, g = stack_bwd(params, caches[m], din, heads, eps, dot)
            caches[m] = None
            counts["backward"] += 1
            grads = _gsum(grads, g)
            if me == 0:
                dxs[m] = dx
            else:
                sends.append((-1, dx, m))
        nxt = t - (n_stage - 2 - me)
        recvs = [(1, shape, torch.float32, err.device, nxt)] \
            if me < n_stage - 1 and 0 <= nxt < n_micro else []
        got = stage_hop(mesh, axis, sends, recvs)
        recv = got[0] if recvs else None
    dx = _psum_stage(dxs, me == 0, mesh, axis).reshape(err.shape)
    return dx, grads


def build_1f1b_schedule(n_stage, n_micro):
    """Host-side static schedule: (actions, fidx, bidx) as (T, P) int32
    arrays — at tick t stage s performs actions[t, s] (0 idle, 1 forward,
    2 backward) on microbatch fidx/bidx[t, s]. Classic non-interleaved
    1F1B: stage s runs ``P − s`` warm-up forwards, then alternates
    backward and forward, then drains backwards; the peak stash of stage
    s is ``min(M, P − s)`` microbatches. Built by simulation with explicit
    causality (an F/B consumes its neighbour's output from a strictly
    earlier tick). The reference's, as it is."""
    P, M = int(n_stage), int(n_micro)
    f_done = [[-1] * M for _ in range(P)]
    b_done = [[-1] * M for _ in range(P)]
    f_cnt = [0] * P
    b_cnt = [0] * P
    actions, fidx, bidx = [], [], []
    t = 0
    while any(b < M for b in b_cnt):
        act_t, f_t, b_t = [], [], []
        for s in range(P):
            f, b = f_cnt[s], b_cnt[s]
            can_f = f < M and (s == 0 or f_done[s - 1][f] >= 0) \
                and (f - b) < max(P - s, 1)
            can_b = b < M and (
                (s == P - 1 and f_done[s][b] >= 0)
                or (s < P - 1 and b_done[s + 1][b] >= 0))
            warm = (f - b) >= max(P - s, 1) or f == M
            if can_b and (warm or not can_f):
                act_t.append(2)
                f_t.append(0)
                b_t.append(b)
            elif can_f:
                act_t.append(1)
                f_t.append(f)
                b_t.append(0)
            else:
                act_t.append(0)
                f_t.append(0)
                b_t.append(0)
        for s in range(P):
            if act_t[s] == 1:
                f_done[s][f_t[s]] = t
                f_cnt[s] += 1
            elif act_t[s] == 2:
                b_done[s][b_t[s]] = t
                b_cnt[s] += 1
        actions.append(act_t)
        fidx.append(f_t)
        bidx.append(b_t)
        t += 1
        if t > 4 * (M + P):
            raise RuntimeError("1F1B schedule did not converge")
    return (numpy.asarray(actions, numpy.int32),
            numpy.asarray(fidx, numpy.int32),
            numpy.asarray(bidx, numpy.int32))


def pipeline_1f1b_step(params, x, targets, err_fn, mesh, axis="pipe",
                       n_micro=4, heads=4, causal=True, eps=1e-5,
                       dot=torch.matmul):
    """One 1F1B segment of this rank's f32 rows ``x`` (b, S, D): the
    forwards and backwards of :func:`build_1f1b_schedule`, the last stage
    turning each finished forward into its error by ``err_fn(y_mb,
    targets_mb) -> (err_mb, loss)`` -> (y, dx, the stage's gradients,
    the loss summed over the microbatches), y, dx and the loss on every
    stage. Sums over the microbatches, never means: an ``err_fn`` with the
    minibatch's denominator in it needs no rescale."""
    n_stage, me = _stage(mesh, axis)
    actions, fidx, bidx = build_1f1b_schedule(n_stage, n_micro)
    b = x.shape[0]
    bm = b // n_micro
    shape = (bm,) + tuple(x.shape[1:])
    xs = x.reshape((n_micro,) + shape)
    ts = targets.reshape((n_micro, bm) + tuple(targets.shape[1:]))
    last = me == n_stage - 1
    outs = torch.zeros((n_micro,) + shape, dtype=torch.float32,
                       device=x.device)
    dxs = torch.zeros_like(outs)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    caches, errs, got_f, got_b = {}, {}, {}, {}
    grads = None
    for t in range(len(actions)):
        act = actions[t, me]
        sends = []
        if act == 1:
            m = int(fidx[t, me])
            y, caches[m] = stack_fwd(
                params, xs[m] if me == 0 else got_f.pop(m), heads, causal,
                eps, dot)
            counts["forward"] += 1
            if last:
                errs[m], mb_loss = err_fn(y, ts[m])
                loss = loss + mb_loss
                outs[m] = y
            else:
                sends.append((1, y, m))
        elif act == 2:
            m = int(bidx[t, me])
            din = errs.pop(m) if last else got_b.pop(m)
            dx, g = stack_bwd(params, caches.pop(m), din, heads, eps, dot)
            counts["backward"] += 1
            grads = _gsum(grads, g)
            if me == 0:
                dxs[m] = dx
            else:
                sends.append((-1, dx, m))
        recvs = []
        if me > 0 and actions[t, me - 1] == 1:
            recvs.append((-1, shape, torch.float32, x.device,
                          int(fidx[t, me - 1])))
        if not last and actions[t, me + 1] == 2:
            recvs.append((1, shape, torch.float32, x.device,
                          int(bidx[t, me + 1])))
        for (shift, _, _, _, m), tensor in zip(
                recvs, stage_hop(mesh, axis, sends, recvs)):
            (got_f if shift < 0 else got_b)[m] = tensor
    n = outs.numel()
    yl = _psum_stage(torch.cat([outs.reshape(-1), loss.reshape(1)]), last,
                     mesh, axis)
    dx = _psum_stage(dxs, me == 0, mesh, axis).reshape(x.shape)
    return yl[:n].reshape(x.shape), dx, grads, yl[n]
