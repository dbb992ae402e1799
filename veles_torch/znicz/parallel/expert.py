"""The all-to-all expert exchange for the MoE units.

Counterpart of ``veles/znicz_tpu/parallel/expert.py`` (the GShard/Switch
exchange, ``root.lm.parallel.ep_routing="alltoall"``): each rank routes
its own tokens and ships each expert exactly the slots routed to it, so
the tokens move once (O(tokens)), where the gather mode
(``ops/moe.py``) gathers the token block of the whole ``expert`` line
onto every rank (O(E)).

Token layout, the reference's: inside the exchange the tokens shard over
EVERY mesh axis, so every rank owns a distinct source shard of ``b'``
whole rows (all S positions). Outside it a rank holds its rows (``data``
and ``expert`` shard the batch) and, under ``seq``, its positions: the
exchange first re-shards them over ``seq`` (an all-to-all over the axis:
rows cut into ``n_seq`` blocks, positions put together), and under
``model`` (tokens replicated over it) keeps the ``model``-th block of
rows; after, the reverse all-to-all and an all-gather over ``model``
rebuild the rank's tokens. The source shards are the reference's (the
minibatch cut into blocks of ``b'`` rows); which rank holds which block
does not change a result.

Per source shard (``T_loc = b'·S`` tokens, capacity ``C =
ceil(cf·T_loc/E)`` a shard, the reference's quota):

1. route the shard's tokens (``ops/moe.route_tokens``) -> dispatch
   (T_loc, E, C);
2. pack the (E, C, D) slot buffers and ``all_to_all`` them over
   ``expert``: chunk j of the experts to rank j, the chunks received
   put side by side on the capacity dim -> (E/n, n·C, D);
3. the rank's experts on their slots;
4. the reverse all-to-all brings the outputs home; combine with the
   gates.

The backward mirrors it (the transpose of an all-to-all is the reverse
one). The load-balancing term uses the GLOBAL routing frequency (the
shards' means summed over every token axis, one small all-reduce: the
reference's ``pmean``); expert gradients sum over every token axis but
``expert``, router gradients over all of them (``reduce_axes``, summed
by the step's gradient all-reduces).

The quota is per source shard, as the reference's: a shard skewed
toward one expert drops tokens the global quota would keep, and an
expert fed by many shards keeps tokens it would drop. With a capacity
factor at which no shard overflows, the exchange equals one device.
"""

import torch

from veles_torch.znicz.ops import moe as M
from veles_torch.znicz.parallel import collectives as C


def token_axes(unit):
    """The mesh axes the tokens shard over inside the exchange: every
    axis of the unit's mesh, in its order."""
    return tuple(unit.mesh.axis_names)


def _seq_size(unit):
    return unit.mesh.shape[unit.seq_axis] if unit.seq_axis else 1


def _model_size(unit):
    return unit.mesh.shape[unit.model_axis] if unit.model_axis else 1


def to_shard(unit, t):
    """This rank's (b, s, ·) tokens -> its source shard (b', S, ·)."""
    ns = _seq_size(unit)
    if ns > 1:
        b, s = t.shape[:2]
        sent = t.reshape((ns, b // ns) + tuple(t.shape[1:])).contiguous()
        got = C.all_to_all(sent, unit.mesh, unit.seq_axis)
        t = got.transpose(0, 1).reshape((b // ns, ns * s)
                                        + tuple(t.shape[2:]))
    nm = _model_size(unit)
    if nm > 1:
        per = t.shape[0] // nm
        lo = unit.mesh.index(unit.model_axis) * per
        t = t[lo:lo + per]
    return t


def from_shard(unit, t):
    """The inverse of :func:`to_shard`: the source shard's (b', S, ·)
    -> this rank's (b, s, ·)."""
    nm = _model_size(unit)
    if nm > 1:
        t = torch.cat(C.all_gather(t.contiguous(), unit.mesh,
                                   unit.model_axis), dim=0)
    ns = _seq_size(unit)
    if ns > 1:
        bs, full = t.shape[:2]
        s = full // ns
        sent = t.reshape((bs, ns, s) + tuple(t.shape[2:])).transpose(0, 1)
        got = C.all_to_all(sent.contiguous(), unit.mesh, unit.seq_axis)
        t = got.reshape((ns * bs, s) + tuple(t.shape[2:]))
    return t


def _exchange(unit, slots):
    """(E, C, D) slot buffers of this shard -> (E/n, n·C, D): every
    shard's slots of this rank's experts, side by side."""
    n = unit.mesh.shape[unit.expert_axis]
    e, c, d = slots.shape
    got = C.all_to_all(slots.contiguous(), unit.mesh, unit.expert_axis)
    return got.view(n, e // n, c, d).transpose(0, 1).reshape(
        e // n, n * c, d)


def _return(unit, slots):
    """The inverse of :func:`_exchange`: (E/n, n·C, D) -> this shard's
    (E, C, D)."""
    n = unit.mesh.shape[unit.expert_axis]
    el, nc, d = slots.shape
    sent = slots.view(el, n, nc // n, d).transpose(0, 1).contiguous()
    return C.all_to_all(sent, unit.mesh, unit.expert_axis).view(
        el * n, nc // n, d)


def a2a_forward(unit, x):
    """The exchange's forward of this rank's f32 tokens ``x`` (b, s, D) ->
    (y without the residual, cache)."""
    dot = unit.device.dot
    p = unit.export_params()
    xs = to_shard(unit, x)
    xt = xs.reshape(-1, xs.shape[-1])
    cap = unit.capacity(xt.shape[0])
    probs, onehot_e, gate, dispatch = M.route_tokens(
        xt, p["router"], unit.experts, cap)
    xe = _exchange(unit, M.dispatch_tokens(dispatch, xt, dot))
    h, ye = M.experts_fwd(xe, p["weights"], p["bias"], p["weights2"],
                          p["bias2"], unit.ACTIVATION, dot)
    ye_local = _return(unit, ye)
    yt = M.combine_slots(dispatch * gate[:, None, None], ye_local, dot)
    unit.dropped = xt.shape[0] - dispatch.sum()
    cache = {"probs": probs, "onehot_e": onehot_e, "gate": gate,
             "dispatch": dispatch, "xe": xe, "h": h, "ye": ye_local,
             "xs": xs}
    return from_shard(unit, yt.view(xs.shape)), cache


def a2a_backward(gd, x, err):
    """The exchange's backward for this rank's f32 ``x`` and ``err`` ->
    (dx without the residual's err, grads of this rank's experts and of
    the router over its source shard)."""
    f = gd.forward
    dot = f.device.dot
    c = f.cache
    xs, es = c["xs"], to_shard(f, err)
    d = xs.shape[-1]
    xt, dyt = xs.reshape(-1, d), es.reshape(-1, d)
    dispatch, gate, probs, onehot_e = (c["dispatch"], c["gate"],
                                       c["probs"], c["onehot_e"])
    xe, h = c["xe"], c["h"]
    dye = _exchange(f, M.dispatch_tokens(dispatch * gate[:, None, None],
                                         dyt, dot))
    dgate = (M.combine_slots(dispatch, c["ye"], dot) * dyt).sum(dim=-1)
    grads, dxe = M.experts_bwd(dye, xe, h, f.weights, f.weights2,
                               f.ACTIVATION, dot)
    dxt = M.combine_slots(dispatch, _return(f, dxe), dot)
    # the global routing frequency: the shards' means, averaged
    axes = token_axes(f)
    shards = f.mesh.axis_size(axes)
    freq = C.all_reduce(onehot_e.mean(dim=0), f.mesh, axes) / shards
    scale = float(gd.aux_weight) * f.experts / (xt.shape[0] * shards)
    grads["router"], dxr = M.router_bwd(xt, probs, onehot_e, dgate, freq,
                                        scale, f.router)
    return from_shard(f, (dxt + dxr).view(xs.shape)), grads
