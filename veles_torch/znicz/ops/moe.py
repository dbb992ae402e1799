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
bias-gradient kernel takes one (N, K) sum). Expert parallelism is
ROADMAP Queue 1 item 10c.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.ops import activations as A


def _one_hot(idx, n):
    return (torch.arange(n, device=idx.device) == idx[..., None]).to(
        torch.float32)


def capacity(capacity_factor, n_tokens, experts):
    """Per-expert token capacity for ``n_tokens`` tokens."""
    return max(1, int(numpy.ceil(capacity_factor * n_tokens / experts)))


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
        #: tokens the last forward dropped (a device scalar)
        self.dropped = None

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
        y, self.cache = moe_forward(
            x, self.export_params(), self.experts, self.capacity_factor,
            self.ACTIVATION, self.device.dot)
        self.dropped = x.numel() // x.shape[-1] - self.cache["dispatch"].sum()
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
        dh = dot(dye, f.weights2.transpose(1, 2)) \
            * A.ACTIVATIONS[f.ACTIVATION][1](h)
        grads = {"weights2": dot(h.transpose(1, 2), dye),
                 "bias2": dye.sum(dim=1),
                 "weights": dot(xe.transpose(1, 2), dh),
                 "bias": dh.sum(dim=1)}
        dxt = combine_slots(dispatch, dot(dh, f.weights.transpose(1, 2)),
                            dot)
        # d aux / d probs = aux_w·E/T · f, the routing frequency constant
        scale = numpy.float32(self.aux_weight) * f.experts / xt.shape[0]
        dprobs = onehot_e * dgate[:, None] \
            + float(scale) * onehot_e.mean(dim=0)[None, :]
        dlogits = probs * (dprobs - (dprobs * probs).sum(dim=-1,
                                                         keepdim=True))
        grads["router"] = torch.matmul(xt.t(), dlogits)
        dx = (dxt + torch.matmul(dlogits, f.router.t())).reshape(x.shape)
        if f.residual:
            dx = dx + err
        return dx, grads

    def run(self, x, y, err):
        f = self.forward
        x = x.to(torch.float32)
        dx, grads = self.backward(x, err.reshape(x.shape).to(torch.float32))
        f.cache = None
        self.update_weights(grads["weights"], grads["bias"])
        self.update_extra(grads)
        return dx.to(f.device.act_dtype) if self.need_err_input else None
