"""Blocked (flash-style) attention of the port, as plain PyTorch.

Counterpart of ``veles/znicz_tpu/parallel/flash.py``: the (B, H, S, S)
score matrix is never formed; a Python loop walks the K/V blocks with
the online softmax (running max ``m``, denominator ``l`` and output
``acc``, all f32), and the backward recomputes each block's
probabilities from the saved logsumexp. The reference writes the loop
as ``lax.scan`` outside any Pallas kernel, so its port is
``torch.matmul`` through the device's ``dot`` (compute-dtype inputs, f32
sums), not a hand-written kernel; the flash kernels
(``ops/flash_attention.py``) are the other mode of the attention unit.

The reference's details are kept: the causal mask is the additive
``-1e9`` (a fully masked row never occurs: a query sees its own key),
``p`` is cast to the compute dtype before the PV / dV / dK products, and
``delta = rowsum(dout·out)`` is taken in f32.
"""

import torch

from veles_torch.znicz.ops.flash_attention import scale_for

#: the additive causal mask of the reference's scan
SCAN_MASK = -1e9


def _blocks(t, block):
    b, h, s, dh = t.shape
    if s % block:
        raise ValueError("block %d does not divide sequence %d"
                         % (block, s))
    return t.split(block, dim=2)


def _masked_scores(q, k_blk, i, block, causal, scale, dot):
    """(B, H, S, block) f32 scores of the queries against K block ``i``,
    with the additive causal mask."""
    sc = dot(q, k_blk.transpose(-1, -2)) * scale
    if causal:
        s = q.shape[2]
        qpos = torch.arange(s, device=q.device)
        kpos = i * block + torch.arange(block, device=q.device)
        mask = (kpos[None, :] > qpos[:, None]).to(torch.float32) \
            * SCAN_MASK
        sc = sc + mask
    return sc


def blocked_attention_fwd(q, k, v, causal=True, block=128,
                          dot=torch.matmul):
    """q/k/v (B, H, S, dh) -> (out in q's dtype, f32 lse (B, H, S)):
    softmax(q·kᵀ/sqrt(dh))·v over K/V blocks of ``block`` (which must
    divide S). ``dot``: the matmul (the device's, f32 sums)."""
    b, h, s, dh = q.shape
    scale = scale_for(dh)
    kb, vb = _blocks(k, block), _blocks(v, block)
    m = torch.full((b, h, s), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dh), dtype=torch.float32, device=q.device)
    for i, (k_blk, v_blk) in enumerate(zip(kb, vb)):
        sc = _masked_scores(q, k_blk, i, block, causal, scale, dot)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        coef = torch.exp(m - m_new)
        l = l * coef + p.sum(dim=-1)
        acc = acc * coef[..., None] + dot(p.to(q.dtype), v_blk)
        m = m_new
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def blocked_attention_bwd(q, k, v, out, lse, dout, causal=True, block=128,
                          dot=torch.matmul, delta=None):
    """Backward of :func:`blocked_attention_fwd` by block recomputation
    from ``lse`` -> (dq, dk, dv) in q's dtype. ``delta``: an optional
    precomputed f32 ``rowsum(dout·out)`` (B, H, S), as the ring hands
    its one copy to every step."""
    b, h, s, dh = q.shape
    scale = scale_for(dh)
    if delta is None:
        delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
    dq = torch.zeros((b, h, s, dh), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i, (k_blk, v_blk) in enumerate(zip(_blocks(k, block),
                                           _blocks(v, block))):
        sc = _masked_scores(q, k_blk, i, block, causal, scale, dot)
        p = torch.exp(sc - lse[..., None])
        dp = dot(dout, v_blk.transpose(-1, -2))
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + dot(ds, k_blk)
        dks.append(dot(ds.transpose(-1, -2), q))
        dvs.append(dot(p.to(q.dtype).transpose(-1, -2), dout))
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(q.dtype),
            torch.cat(dvs, dim=2).to(q.dtype))
