"""Plain reference of the causal transformer LM the benchmark trains.

Token embedding plus fixed sinusoidal positions, then per layer
multi-head causal self-attention with its residual, LayerNorm, a ReLU
FFN with its residual and LayerNorm (post-LN), then the vocabulary head
and the mean next-token cross-entropy over every position. The
parameters are in the layout the benchmark hands to the program
(:func:`leaves`). Plain PyTorch in float32 with autograd; each layer and
each block of queries is recomputed in the backward pass
(``torch.utils.checkpoint``), so a long sequence fits.
"""

import numpy
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import Precision

#: queries a block of the attention core; recomputed in the backward
QUERY_BLOCK = 1024
LN_EPS = 1e-5


def shape(model):
    return (int(model["hidden_size"]), int(model["num_attention_heads"]),
            int(model["num_hidden_layers"]),
            int(model["intermediate_size"]), int(model["vocab_size"]))


def leaves(model):
    """[(name, shape, kind, fan_in, fan_out)]: ``kind`` "w" a matrix
    (Glorot-uniform), "b" a bias (zeros), "g" a LayerNorm gain (ones)."""
    d, _, layers, f, v = shape(model)
    out = [("emb", (v, d), "w", v, d)]
    for i in range(layers):
        p = "l%d." % i
        out += [(p + "qkv.w", (d, 3 * d), "w", d, 3 * d),
                (p + "qkv.b", (3 * d,), "b", 0, 0),
                (p + "out.w", (d, d), "w", d, d),
                (p + "out.b", (d,), "b", 0, 0),
                (p + "ln1.g", (d,), "g", 0, 0),
                (p + "ln1.b", (d,), "b", 0, 0),
                (p + "ffn1.w", (d, f), "w", d, f),
                (p + "ffn1.b", (f,), "b", 0, 0),
                (p + "ffn2.w", (f, d), "w", f, d),
                (p + "ffn2.b", (d,), "b", 0, 0),
                (p + "ln2.g", (d,), "g", 0, 0),
                (p + "ln2.b", (d,), "b", 0, 0)]
    out += [("head.w", (d, v), "w", d, v), ("head.b", (v,), "b", 0, 0)]
    return out


def positions(seq, dim, device):
    """(seq, dim) float32: sin on even features, cos on odd ones, of
    pos / 10000^(2·(i // 2) / dim)."""
    pos = numpy.arange(seq, dtype=numpy.float32)[:, None]
    i = numpy.arange(dim, dtype=numpy.float32)[None, :]
    angle = pos / numpy.power(numpy.float32(10000.0),
                              (2.0 * (i // 2)) / dim)
    enc = numpy.where(i.astype(numpy.int64) % 2 == 0, numpy.sin(angle),
                      numpy.cos(angle)).astype(numpy.float32)
    return torch.as_tensor(enc, device=device)


def layer_norm(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc / torch.sqrt(var + LN_EPS) * g + b


def _attend_block(q, k, v, lo, scale, prec):
    """Causal attention of the queries ``lo`` … ``lo + len(q)`` over the
    keys up to the last of them."""
    s = prec.matmul(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(lo, lo + q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    return prec.matmul(torch.softmax(s, dim=-1), v)


def attention(q, k, v, prec):
    """Causal softmax(q·kᵀ/√dh)·v over (B, H, S, dh), block by block."""
    seq, dh = q.shape[2], q.shape[3]
    scale = float(numpy.float32(1.0 / numpy.sqrt(dh)))
    out = []
    for lo in range(0, seq, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, seq)
        out.append(checkpoint(_attend_block, q[:, :, lo:hi], k[:, :, :hi],
                              v[:, :, :hi], lo, scale, prec,
                              use_reentrant=False))
    return torch.cat(out, dim=2)


def _layer(x, p, heads, prec):
    b, s, d = x.shape
    qkv = prec.matmul(x, p["qkv.w"]) + p["qkv.b"]

    def split(t):
        return t.reshape(b, s, heads, d // heads).transpose(1, 2)

    q, k, v = (split(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    a = attention(q, k, v, prec).transpose(1, 2).reshape(b, s, d)
    x = x + prec.matmul(a, p["out.w"]) + p["out.b"]
    x = layer_norm(x, p["ln1.g"], p["ln1.b"])
    h = torch.relu(prec.matmul(x, p["ffn1.w"]) + p["ffn1.b"])
    x = x + prec.matmul(h, p["ffn2.w"]) + p["ffn2.b"]
    return layer_norm(x, p["ln2.g"], p["ln2.b"])


def loss(params, batch, model, prec=None):
    """Mean next-token cross-entropy of ``batch`` = (ids, labels), both
    (B, S) integer tensors."""
    prec = prec or Precision()
    ids, labels = batch
    d, heads, layers, _, v = shape(model)
    x = params["emb"][ids.long()] + positions(ids.shape[1], d, ids.device)
    for i in range(layers):
        p = {k[len("l%d." % i):]: t for k, t in params.items()
             if k.startswith("l%d." % i)}
        x = checkpoint(_layer, x, p, heads, prec, use_reentrant=False)
    logits = prec.matmul(x, params["head.w"]) + params["head.b"]
    return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1).long())
