"""Plain reference of the one-tower AlexNet the benchmark trains.

Per conv block: a convolution of stride and padding as configured, its
bias and softplus (log(1 + eˣ)), where configured the cross-map LRN
``x·(k + α·Σ x²)^(−β)`` over the ``n`` channels centred on each, and the
overlapping ceil-mode max pool; then per FC block inverted dropout
``(u < keep)/keep`` and an FC with softplus, and the softmax classifier
with the mean cross-entropy. The dropout uniforms are drawn from the
generators the benchmark hands to both sides, one draw of the NHWC
shape per train forward, as the program draws them. The minibatch is
the uint8 bank's center crop, every other row mirrored in a train step,
scaled to [−1, 1]. The parameters are in the layout the benchmark hands
to the program (:func:`leaves`): a conv's weights are (filters,
ky·kx·channels), an FC's (inputs, outputs), inputs in NHWC order.
Plain PyTorch in float32 with autograd.
"""

import math

import torch
import torch.nn.functional as F

from reference.common import Precision

#: the largest loss a row reports (its class's probability under 1e-30)
LOSS_CAP = -math.log(1e-30)


def leaves(model):
    """[(name, shape, kind, fan_in, fan_out)] ("w" Glorot-uniform, "b"
    zeros)."""
    out = []
    c = 3
    h, w = model["crop"]
    for i, conv in enumerate(model["convs"]):
        k, f = conv["kernel"], conv["filters"]
        fan_in = k * k * c
        out += [("conv%d.w" % (i + 1), (f, fan_in), "w", fan_in, f),
                ("conv%d.b" % (i + 1), (f,), "b", 0, 0)]
        h = (h + 2 * conv["padding"] - k) // conv["stride"] + 1
        w = (w + 2 * conv["padding"] - k) // conv["stride"] + 1
        c = f
        if conv.get("pool"):
            pk, ps = model["pool"]["kernel"], model["pool"]["stride"]
            h = -(-max(h - pk, 0) // ps) + 1
            w = -(-max(w - pk, 0) // ps) + 1
    n_in = h * w * c
    widths = list(model["fc"]) + [int(model["num_classes"])]
    for j, n_out in enumerate(widths):
        name = "fc%d" % (len(model["convs"]) + 1 + j)
        out += [(name + ".w", (n_in, n_out), "w", n_in, n_out),
                (name + ".b", (n_out,), "b", 0, 0)]
        n_in = n_out
    return out


def batch_images(bank, idx, model, train):
    """uint8 (N, H, W, 3) bank rows ``idx`` -> float32 (B, ch, cw, 3):
    the center crop, even rows mirrored when ``train``, scaled to
    [−1, 1]."""
    sh, sw = model["scale"]
    ch, cw = model["crop"]
    y, x = (sh - ch) // 2, (sw - cw) // 2
    data = bank[idx][:, y:y + ch, x:x + cw, :]
    if train:
        even = (torch.arange(data.shape[0], device=data.device) % 2 == 0)
        data = torch.where(even[:, None, None, None], data.flip(2), data)
    return (data.to(torch.float32) / 255.0 - 0.5) / 0.5


def lrn(x, n, alpha, beta, k):
    """Cross-map LRN of NCHW ``x`` over the ``n`` channels centred on
    each (the lower half the larger for an even ``n``)."""
    lo = (n - 1) // 2
    sq = F.pad(x * x, (0, 0, 0, 0, lo, n - 1 - lo))
    c = x.shape[1]
    total = sum(sq[:, i:i + c] for i in range(n))
    return x * torch.pow(k + alpha * total, -beta)


def loss(params, batch, model, prec=None):
    """Mean cross-entropy of ``batch`` = (images (B, ch, cw, 3) float32,
    labels (B,), dropout generators): one uniform draw of each dropout's
    NHWC input shape from its generator, in order."""
    return loss_rows(params, batch, model, prec).mean()


def loss_rows(params, batch, model, prec=None):
    """The cross-entropy of each row of ``batch`` (see :func:`loss`)."""
    prec = prec or Precision()
    images, labels, gens = batch
    x = images.permute(0, 3, 1, 2)
    cfg_lrn = model["lrn"]
    for i, conv in enumerate(model["convs"]):
        w = params["conv%d.w" % (i + 1)]
        k = conv["kernel"]
        w4 = w.reshape(w.shape[0], k, k, x.shape[1]).permute(0, 3, 1, 2)
        v = prec.conv2d(x, w4, conv["stride"], conv["padding"])
        x = F.softplus(v + params["conv%d.b" % (i + 1)][None, :, None, None])
        if conv.get("lrn"):
            x = lrn(x, cfg_lrn["n"], cfg_lrn["alpha"], cfg_lrn["beta"],
                    cfg_lrn["k"])
        if conv.get("pool"):
            x = F.max_pool2d(x, model["pool"]["kernel"],
                             model["pool"]["stride"], ceil_mode=True)
    x = x.permute(0, 2, 3, 1)                    # NHWC, as the FCs read it
    keep = 1.0 - float(model["dropout"])
    n_fc = len(model["fc"])
    first = len(model["convs"]) + 1
    for j in range(n_fc + 1):
        name = "fc%d" % (first + j)
        if j < n_fc:
            u = torch.rand(x.shape, generator=gens[j], device=x.device)
            x = x * ((u < keep).to(torch.float32) / keep)
        v = prec.matmul(x.reshape(x.shape[0], -1), params[name + ".w"]) \
            + params[name + ".b"]
        x = F.softplus(v) if j < n_fc else v
    rows = F.cross_entropy(x, labels.long(), reduction="none")
    # the loss the configuration reports: −log max(p, 1e-30) a row, its
    # gradient softmax − one-hot even where the cap holds
    return rows + (rows.clamp(max=LOSS_CAP) - rows).detach()
