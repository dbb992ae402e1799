"""Mixture-of-Experts FFN unit pair of the port.

Counterpart of ``veles/znicz_tpu/ops/moe.py`` (Switch-style top-1
routing with a fixed per-expert capacity, GShard's dense formulation):

* router logits ``x·R`` (f32) -> softmax probs; each token goes to its
  top-1 expert (the first of equal maxima) with gate weight ``p_max``;
* each expert takes at most ``C = ceil(capacity_factor·T/E)`` tokens, in
  token order; the overflow bypasses the experts (the residual carries
  it: Switch's dropped tokens);
* dispatch and combine are dense one-hot products over a (T, E, C)
  assignment, the experts one batched FFN over (E, C, D) slot buffers;
* the load-balancing loss ``aux_weight·E·Σ_e f_e·P_e`` enters the
  backward analytically (f, the routing frequency, held constant), the
  assignment itself straight-through.

The products run through the device's ``dot`` (compute-dtype inputs, f32
sums), as the reference's ``ctx.einsum``; the router's products are plain
f32 matmuls, as the reference's ``@``. The experts' bias sums are plain
f32 sums over each expert's slots (E sums of (C, K) per launch; the
bias-gradient kernel takes one (N, K) sum).

On a mesh (``mesh`` set by the parallel setups) the unit routes every
token of the minibatch under the ONE global quota, as one device does,
though its rank holds only its rows (``data``, and ``expert`` in EP) and
its positions (``seq``): each rank counts its tokens per row and expert,
the counts are all-gathered over the token axes it does not gather
tokens over, and a token's slot is its rank among the tokens of its
expert in the global (row, position) order. ``dropped`` is the global
count. Under ``model`` the unit is replicated. Expert parallelism
(``parallel.setup_expert_parallel``) shards the experts over ``expert``
(E/n a rank) and routes tokens one of two ways:

* ``"gather"``: the token block of the rank's ``expert`` line is
  all-gathered (the reference's GSPMD lowering moves it so), each rank
  runs its experts on the slots of the line's tokens, and the partial
  outputs are all-reduced over ``expert`` (:func:`combine_sum`); the
  backward gathers the line's output gradients and all-reduces the
  partial input and gate gradients;
* ``"alltoall"``: the GShard exchange of ``parallel/expert.py``, with a
  quota per source shard.

Expert gradients sum over the token axes but ``expert``, router
gradients over all of them (``reduce_axes``).
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.parallel import collectives as C


def _one_hot(idx, n):
    return (torch.arange(n, device=idx.device) == idx[..., None]).to(
        torch.float32)


def capacity(capacity_factor, n_tokens, experts):
    """Per-expert token capacity for ``n_tokens`` tokens."""
    return max(1, int(numpy.ceil(capacity_factor * n_tokens / experts)))  # zlint: disable=tracer-purity (n_tokens is the host int global_positions returns; its tuple unpack reads as device data)


def route_tokens(xt, router, experts, cap):
    """Top-1 routing of flat f32 tokens (T, D) -> (probs, onehot_e, gate,
    dispatch): ``dispatch`` (T, E, C) is the one-hot token -> (expert,
    slot) assignment, the slot a token's rank among the tokens of its
    expert; ranks from ``cap`` on are dropped (all-zero rows)."""
    logits = torch.matmul(xt, router)
    probs = A.softmax(logits)
    onehot_e = _one_hot(torch.argmax(logits, dim=-1), experts)
    gate = (probs * onehot_e).sum(dim=-1)
    pos_t = ((torch.cumsum(onehot_e, dim=0) - 1.0) * onehot_e).sum(dim=-1)
    keep = (pos_t < cap).to(torch.float32)
    slot = _one_hot(pos_t.to(torch.int32), cap)
    dispatch = onehot_e[:, :, None] * slot[:, None, :] * keep[:, None, None]
    return probs, onehot_e, gate, dispatch


def _flat(dispatch):
    """(T, E, C) -> (T, E·C)."""
    return dispatch.reshape(dispatch.shape[0], -1)


def dispatch_tokens(dispatch, xt, dot):
    """``tec,td->ecd``: the tokens into their (E, C, D) slots."""
    e, c = dispatch.shape[1:]
    return dot(_flat(dispatch).t(), xt).reshape(e, c, xt.shape[-1])


def combine_slots(combine, ye, dot):
    """``tec,ecd->td``: slot outputs back to the tokens."""
    return dot(_flat(combine), ye.reshape(-1, ye.shape[-1]))


def experts_fwd(xe, w1, b1, w2, b2, activation, dot):
    """The batched expert FFN over (E, C, D) slots -> (h, ye)."""
    h = A.ACTIVATIONS[activation][0](dot(xe, w1) + b1[:, None, :])
    return h, dot(h, w2) + b2[:, None, :]


def experts_bwd(dye, xe, h, w1, w2, activation, dot):
    """Backward of :func:`experts_fwd` for the slots' output gradient
    ``dye`` -> (the experts' gradients, the slots' input gradient)."""
    dh = dot(dye, w2.transpose(1, 2)) * A.ACTIVATIONS[activation][1](h)
    grads = {"weights2": dot(h.transpose(1, 2), dye),
             "bias2": dye.sum(dim=1),
             "weights": dot(xe.transpose(1, 2), dh),
             "bias": dh.sum(dim=1)}
    return grads, dot(dh, w1.transpose(1, 2))


def router_bwd(xt, probs, onehot_e, dgate, freq, scale, router):
    """The router's backward through the softmax gate, with the
    load-balancing term ``scale · freq`` (``freq`` the routing frequency,
    held constant; the assignment straight-through) -> (the router's
    gradient, the tokens' input gradient through it)."""
    dprobs = onehot_e * dgate[:, None] + scale * freq[None, :]
    dlogits = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True))
    return torch.matmul(xt.t(), dlogits), torch.matmul(dlogits, router.t())


def combine_sum(unit, t):
    """Gather mode's combine: the experts' partial outputs of the line's
    tokens summed over the unit's ``expert`` axis."""
    return C.all_reduce(t, unit.mesh, unit.expert_axis)


def expert_range(unit):
    """[lo, hi) of the experts this rank holds (all of them off EP)."""
    if unit.expert_axis is None:
        return 0, unit.experts
    n = unit.mesh.shape[unit.expert_axis]
    per = unit.experts // n
    lo = unit.mesh.index(unit.expert_axis) * per
    return lo, lo + per


def global_positions(unit, onehot, rows):
    """Each token's rank among the tokens of its expert in the global
    (row, position) order, from ``onehot`` (rows · s, E) of this rank's
    token block (``rows`` rows of its positions): -> (pos (rows · s,),
    every expert's global token count (E,), the global token count). The
    per-row counts go round the unit's count axes (``data``, ``seq``) in
    one all-gather."""
    mesh, e = unit.mesh, unit.experts
    per_row = onehot.view(rows, -1, e)
    cnt = per_row.sum(dim=1)
    count_axes = unit.data_axes + ((unit.seq_axis,) if unit.seq_axis
                                   else ())
    nd = mesh.axis_size(unit.data_axes)
    ns = mesh.axis_size(count_axes) // nd
    every = torch.stack(C.all_gather(cnt.contiguous(), mesh, count_axes))
    every = every.view(nd, ns, rows, e).transpose(1, 2).reshape(-1, e)
    before = torch.cumsum(every, dim=0) - every
    q = mesh.index(unit.seq_axis) if unit.seq_axis else 0
    off = before.view(nd, rows, ns, e)[mesh.index(unit.data_axes), :, q]
    pos = ((torch.cumsum(per_row, dim=1) - 1.0 + off[:, None, :])
           * per_row).sum(dim=-1).reshape(-1)
    return pos, every.sum(dim=0), int(onehot.shape[0]) * nd * ns


def _line(unit, t):
    """The tokens of this rank's ``expert`` line: ``t`` gathered over the
    axis, the ranks' rows one after another (gather mode)."""
    if unit.expert_axis is None:
        return t
    return torch.cat(C.all_gather(t.contiguous(), unit.mesh,
                                  unit.expert_axis), dim=0)


def _mine(unit, t):
    """This rank's rows of a tensor of its line's tokens."""
    if unit.expert_axis is None:
        return t
    n = unit.mesh.shape[unit.expert_axis]
    per = t.shape[0] // n
    lo = unit.mesh.index(unit.expert_axis) * per
    return t[lo:lo + per]


def moe_forward_sharded(unit, x, dot):
    """The MoE FFN (no residual) of this rank's f32 tokens ``x`` (b, s, D)
    on a mesh, routed under the global quota (module docstring) -> (y,
    cache)."""
    p = unit.export_params()
    e = unit.experts
    xl = _line(unit, x)
    xt = xl.reshape(-1, xl.shape[-1])
    logits = torch.matmul(xt, p["router"])
    probs = A.softmax(logits)
    onehot = _one_hot(torch.argmax(logits, dim=-1), e)
    gate = (probs * onehot).sum(dim=-1)
    pos, totals, n_tokens = global_positions(unit, onehot, xl.shape[0])
    cap = capacity(unit.capacity_factor, n_tokens, e)
    lo, hi = expert_range(unit)
    keep = (pos < cap).to(torch.float32)
    slot = _one_hot(pos.to(torch.int32), cap)
    dispatch = onehot[:, lo:hi, None] * slot[:, None, :] \
        * keep[:, None, None]
    xe = dispatch_tokens(dispatch, xt, dot)
    h, ye = experts_fwd(xe, p["weights"], p["bias"], p["weights2"],
                        p["bias2"], unit.ACTIVATION, dot)
    yt = combine_slots(dispatch * gate[:, None, None], ye, dot)
    if unit.expert_axis is not None:
        yt = combine_sum(unit, yt)
    y = _mine(unit, yt.view(xl.shape)).reshape(x.shape)
    cache = {"probs": _mine(unit, probs.view(xl.shape[:2] + (e,))),
             "onehot_e": _mine(unit, onehot.view(xl.shape[:2] + (e,))),
             "gate": gate, "dispatch": dispatch, "xe": xe, "h": h,
             "ye": ye, "totals": totals, "n_tokens": n_tokens}
    unit.dropped = n_tokens - torch.minimum(
        totals, torch.full_like(totals, float(cap))).sum()  # zlint: disable=tracer-purity (cap is capacity()'s host int)
    return y, cache


def moe_backward_sharded(gd, x, err):
    """Backward of :func:`moe_forward_sharded` for this rank's f32 ``x``
    and ``err`` -> (dx, grads): the experts' gradients of this rank's
    experts over the line's tokens, the router's over its own tokens
    (each summed over the ranks by the step, ``reduce_axes``)."""
    f = gd.forward
    dot = f.device.dot
    d = x.shape[-1]
    c = f.cache
    dispatch, gate = c["dispatch"], c["gate"]
    probs = c["probs"].reshape(-1, f.experts)
    onehot_e = c["onehot_e"].reshape(-1, f.experts)
    xe, h, ye = c["xe"], c["h"], c["ye"]
    dyl = _line(f, err).reshape(-1, d)
    dye = dispatch_tokens(dispatch * gate[:, None, None], dyl, dot)
    dgate = (combine_slots(dispatch, ye, dot) * dyl).sum(dim=-1)
    grads, dxe = experts_bwd(dye, xe, h, f.weights, f.weights2,
                             f.ACTIVATION, dot)
    dxt = combine_slots(dispatch, dxe, dot)
    if f.expert_axis is not None:
        both = C.all_reduce(torch.cat([dxt, dgate[:, None]], dim=1),
                            f.mesh, f.expert_axis)
        both = _mine(f, both)
        dxt, dgate = both[:, :d], both[:, d]
    scale = numpy.float32(gd.aux_weight) * f.experts / c["n_tokens"]
    grads["router"], dxr = router_bwd(
        x.reshape(-1, d), probs, onehot_e, dgate,
        c["totals"] / c["n_tokens"], float(scale), f.router)
    return (dxt + dxr).reshape(x.shape), grads


def moe_forward(x, p, experts, capacity_factor, activation, dot):
    """The MoE FFN (no residual) over every token of f32 ``x`` (..., D)
    routed together -> (y, cache)."""
    xt = x.reshape(-1, x.shape[-1])
    probs, onehot_e, gate, dispatch = route_tokens(
        xt, p["router"], experts,
        capacity(capacity_factor, xt.shape[0], experts))
    xe = dispatch_tokens(dispatch, xt, dot)
    h, ye = experts_fwd(xe, p["weights"], p["bias"], p["weights2"],
                        p["bias2"], activation, dot)
    yt = combine_slots(dispatch * gate[:, None, None], ye, dot)
    cache = {"probs": probs, "onehot_e": onehot_e, "gate": gate,
             "dispatch": dispatch, "xe": xe, "h": h, "ye": ye}
    return yt.reshape(x.shape), cache


@forward_unit("moe_ffn")
class MoEFFN(Forward):
    """y = [x +] combine · expert_ffn(dispatch · x), top-1 routed.

    Parameters: ``router`` (D, E); stacked expert matrices ``weights``
    (E, D, H), ``bias`` (E, H), ``weights2`` (E, H, D), ``bias2`` (E, D).
    """

    PARAMS = ("weights", "bias", "weights2", "bias2", "router")
    ACTIVATION = "strict_relu"

    def __init__(self, experts=None, hidden=None, residual=True,
                 capacity_factor=2.0, **kwargs):
        super().__init__(**kwargs)
        if not experts or int(experts) < 2:
            raise ValueError("moe_ffn needs experts >= 2")
        self.experts = int(experts)
        self.hidden = hidden
        self.residual = residual
        self.capacity_factor = float(capacity_factor)
        #: the forward's cache for the GD unit
        self.cache = None
        #: tokens the last forward dropped (a device scalar; on a mesh
        #: the minibatch's, or under ``"alltoall"`` this rank's source
        #: shard's)
        self.dropped = None
        #: the mesh (set by the parallel setups), the axes its batch rows
        #: shard over but ``expert`` (``data_axes``), the ``seq`` and
        #: ``model`` axes, and EP's ``expert`` axis and routing
        self.mesh = None
        self.data_axes = ()
        self.seq_axis = None
        self.model_axis = None
        self.expert_axis = None
        self.routing = "gather"

    def capacity(self, n_tokens):
        return capacity(self.capacity_factor, n_tokens, self.experts)

    def initialize(self, input_shape, device):
        self.device = device
        d = input_shape[-1]
        e, h = self.experts, self.hidden or 4 * d
        self.hidden = h

        def filled(shape, fan_in, fan_out):
            arr = numpy.zeros(shape, numpy.float32)
            self.fill_array(arr, self.weights_filling,
                            self.weights_stddev
                            or self.default_weights_stddev(fan_in, fan_out))
            return torch.as_tensor(arr).to(device.device)

        # the reference's fill order: the numpy generator's draws match
        self.router = filled((d, e), d, e)
        self.weights = filled((e, d, h), d, h)
        self.weights2 = filled((e, h, d), h, d)
        self.bias = torch.zeros((e, h), dtype=torch.float32,
                                device=device.device)
        self.bias2 = torch.zeros((e, d), dtype=torch.float32,
                                 device=device.device)
        return tuple(input_shape)

    def forward(self, x):
        x = x.to(torch.float32)
        if self.mesh is None:
            y, self.cache = moe_forward(
                x, self.export_params(), self.experts,
                self.capacity_factor, self.ACTIVATION, self.device.dot)
            self.dropped = x.numel() // x.shape[-1] \
                - self.cache["dispatch"].sum()
        elif self.routing == "alltoall":
            from veles_torch.znicz.parallel import expert
            y, self.cache = expert.a2a_forward(self, x)
        else:
            y, self.cache = moe_forward_sharded(self, x, self.device.dot)
        if self.residual:
            y = y + x
        return y.to(self.device.act_dtype)


@gradient_for(MoEFFN)
class GDMoEFFN(GradientDescentBase):
    """Hand-written backward: the expert FFN's gradients batched over E,
    the router's through the softmax gate plus the analytic load-balancing
    term, straight-through on the assignment."""

    EXTRA_PARAMS = (("weights2", False), ("bias2", True), ("router", False))

    def __init__(self, aux_weight=0.0, **kwargs):
        super().__init__(**kwargs)
        self.aux_weight = float(aux_weight)

    def backward(self, x, err):
        """(dx, grads) for f32 ``x`` and ``err`` from the forward's
        cache."""
        f = self.forward
        dot = f.device.dot
        d = x.shape[-1]
        xt, dyt = x.reshape(-1, d), err.reshape(-1, d)
        c = f.cache
        dispatch, gate, probs, onehot_e = (c["dispatch"], c["gate"],
                                           c["probs"], c["onehot_e"])
        xe, h, ye = c["xe"], c["h"], c["ye"]
        dye = dispatch_tokens(dispatch * gate[:, None, None], dyt, dot)
        ysel = combine_slots(dispatch, ye, dot)
        dgate = (ysel * dyt).sum(dim=-1)
        grads, dxe = experts_bwd(dye, xe, h, f.weights, f.weights2,
                                 f.ACTIVATION, dot)
        dxt = combine_slots(dispatch, dxe, dot)
        # d aux / d probs = aux_w·E/T · f, the routing frequency constant
        scale = numpy.float32(self.aux_weight) * f.experts / xt.shape[0]
        grads["router"], dxr = router_bwd(
            xt, probs, onehot_e, dgate, onehot_e.mean(dim=0), float(scale),
            f.router)
        dx = (dxt + dxr).reshape(x.shape)
        if f.residual:
            dx = dx + err
        return dx, grads

    def run(self, x, y, err):
        f = self.forward
        x = x.to(torch.float32)
        err = err.reshape(x.shape).to(torch.float32)
        if f.mesh is None:
            dx, grads = self.backward(x, err)
        else:
            if f.routing == "alltoall":
                from veles_torch.znicz.parallel import expert
                dx, grads = expert.a2a_backward(self, x, err)
            else:
                dx, grads = moe_backward_sharded(self, x, err)
            if f.residual:
                dx = dx + err
        f.cache = None
        self.update_weights(grads["weights"], grads["bias"])
        self.update_extra(grads)
        return dx.to(f.device.act_dtype) if self.need_err_input else None
