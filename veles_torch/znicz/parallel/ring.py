"""Ring attention — sequence parallelism over the ``seq`` axis.

Counterpart of ``veles/znicz_tpu/parallel/ring.py``. Each rank holds the
q/k/v of its ``S/n`` positions; the K/V blocks ride the ring
(``collectives.ppermute``, paired ``isend``/``irecv``) while each rank
keeps the online softmax of its own queries, so no rank forms more than
an (S/n × S/n) block of scores.

* :func:`ring_attention_fwd` / :func:`ring_attention_bwd` — the fused
  dense block per ring step (``inner=None``), the reference's
  formulation: an additive ``-1e9`` causal mask on the global positions;
  the backward recomputes every block's probabilities from the saved
  logsumexp and sends (k, v, dk, dv) round a full circle, so dk and dv
  land on their home rank;
* :func:`ring_attention_fwd_flash` / :func:`ring_attention_bwd_flash` —
  each ring step's local block through a flash formulation:
  ``inner="pallas"`` the port's flash kernels (``ops/flash_attention.py``:
  the hand-written sm_90a kernels on the card, their plain versions on
  the CPU), ``inner="scan"`` the blocked scan (``ops/scan_attention.py``).
  Per ring step the three-way dispatch (:func:`_ring_branches`) runs the
  causal kernel on the diagonal shard, the full (non-causal) kernel on a
  past shard and nothing on a future one; the normalized partials merge
  by logsumexp (:func:`_merge_partial`). ``delta = rowsum(dout·out)`` is
  computed once, before the backward ring, and handed to every kernel;
* :func:`ring_self_attention` / :func:`ring_self_attention_bwd` — the
  reference's entry points, which here take the rank's local shards
  (B, H, S/n, dh) and its mesh (the reference's take the global arrays
  under ``shard_map``).

The reference's forward hops K/V after its last step too, and its
backward hops K/V with dK/dV at every step; here the last forward hop
and the backward's last K/V hop, whose results nobody reads, are left
out: (n−1) hops of (k, v) forward, (n−1) of (k, v, dk, dv) and one of
(dk, dv) backward. Where a rank's branch is decided by its own index,
the reference uses ``lax.cond``; here it is Python on the rank's index.
"""

import torch

from veles_torch.znicz.ops.flash_attention import scale_for
from veles_torch.znicz.parallel import collectives as C

#: the additive causal mask of the reference's dense ring
RING_MASK = -1e9


def _qpos_kpos(my, src, sb, device):
    base = torch.arange(sb, device=device)
    return my * sb + base, src * sb + base


def _scores(q, k, causal, my, src, scale, dot):
    """(B, H, Sb, Sb) f32 scores of this rank's queries against the K
    block of rank ``src``, with the additive causal mask."""
    s = dot(q, k.transpose(-1, -2)) * scale
    if causal:
        qpos, kpos = _qpos_kpos(my, src, q.shape[2], q.device)
        s = s + (kpos[None, :] > qpos[:, None]).to(torch.float32) \
            * RING_MASK
    return s


def ring_attention_fwd(q, k, v, mesh, axis, causal, dot=torch.matmul):
    """Forward of the fused dense ring -> (out, lse) of this rank's
    queries over the GLOBAL sequence: out = softmax(q·kᵀ)·v, lse the
    logsumexp of each row's scores."""
    n = mesh.shape[axis]
    my = mesh.index(axis)
    b, h, sb, dh = q.shape
    scale = scale_for(dh)
    m = torch.full((b, h, sb), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sb), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        s = _scores(q, k_cur, causal, my, src, scale, dot)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        coef = torch.exp(m - m_new)
        l = l * coef + p.sum(dim=-1)
        acc = acc * coef[..., None] + dot(p, v_cur)
        m = m_new
        if step < n - 1:
            k_cur, v_cur = C.ppermute([k_cur, v_cur], mesh, axis)
    return acc / l[..., None], m + torch.log(l)


def ring_attention_bwd(q, k, v, out, lse, dout, mesh, axis, causal,
                       dot=torch.matmul):
    """Backward of the fused dense ring -> (dq, dk, dv), dk/dv on their
    home rank after a full circle."""
    n = mesh.shape[axis]
    my = mesh.index(axis)
    scale = scale_for(q.shape[-1])
    delta = (dout * out).sum(dim=-1)
    k_cur, v_cur = k, v
    dk_cur, dv_cur = torch.zeros_like(k), torch.zeros_like(v)
    dq = torch.zeros_like(q)
    for step in range(n):
        src = (my - step) % n
        s = _scores(q, k_cur, causal, my, src, scale, dot)
        p = torch.exp(s - lse[..., None])
        dp = dot(dout, v_cur.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + dot(ds, k_cur)
        dk_cur = dk_cur + dot(ds.transpose(-1, -2), q)
        dv_cur = dv_cur + dot(p.transpose(-1, -2), dout)
        k_cur, v_cur, dk_cur, dv_cur = _backward_hop(
            step, n, mesh, axis, k_cur, v_cur, dk_cur, dv_cur)
    return dq, dk_cur, dv_cur


def _backward_hop(step, n, mesh, axis, k_cur, v_cur, dk_cur, dv_cur):
    """The backward's hop after ring step ``step``: (k, v, dk, dv) on, or
    at the last step only (dk, dv), which then reach their home rank."""
    if step < n - 1:
        return tuple(C.ppermute([k_cur, v_cur, dk_cur, dv_cur], mesh, axis))
    dk_cur, dv_cur = C.ppermute([dk_cur, dv_cur], mesh, axis)
    return k_cur, v_cur, dk_cur, dv_cur


# ---------------------------------------------------------------------------
# flash inner-block kernels


def _inner_kernels(inner, block, dot=None):
    """(fwd, bwd) block-attention kernels for one ring step.
    fwd(q, k, v, causal) -> (out, lse) with out NORMALIZED within the
    block; bwd(q, k, v, out, lse, dout, causal, delta) -> (dq, dk, dv)
    where out/lse are the GLOBAL-row quantities (flash backward
    semantics)."""
    if inner == "pallas":
        from veles_torch.znicz.ops import flash_attention as FA

        def fwd(q, k, v, causal):
            return FA.flash_attention_fwd(q, k, v, causal=causal)

        def bwd(q, k, v, out, lse, dout, causal, delta=None):
            return FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal, delta=delta)
    elif inner == "scan":
        from veles_torch.znicz.ops import scan_attention as SA
        kw = {} if dot is None else {"dot": dot}

        def fwd(q, k, v, causal):
            return SA.blocked_attention_fwd(q, k, v, causal=causal,
                                            block=block, **kw)

        def bwd(q, k, v, out, lse, dout, causal, delta=None):
            return SA.blocked_attention_bwd(q, k, v, out, lse, dout,
                                            causal=causal, block=block,
                                            delta=delta, **kw)
    else:
        raise ValueError("inner must be 'pallas' or 'scan', got %r"
                         % (inner,))
    return fwd, bwd


def _merge_partial(out, lse, o_b, lse_b):
    """logsumexp-merge of two NORMALIZED partial attentions. Guards the
    both-empty case (lse == lse_b == -inf -> coefficient 0, not nan)."""
    new_lse = torch.logaddexp(lse, lse_b)
    empty = torch.isneginf(new_lse)
    zero = torch.zeros((), dtype=torch.float32, device=out.device)
    c1 = torch.where(empty, zero, torch.exp(lse - new_lse))
    c2 = torch.where(empty, zero, torch.exp(lse_b - new_lse))
    return (out * c1[..., None]
            + o_b.to(torch.float32) * c2[..., None]), new_lse


def _ring_branches(causal, src, my, run_causal, run_full, run_skip):
    """The per-ring-step three-way dispatch: diagonal shard -> causal
    kernel, past shard -> full kernel, future shard -> skip (its
    contribution is fully masked)."""
    if not causal:
        return run_full()
    if src == my:
        return run_causal()
    return run_full() if src < my else run_skip()


def ring_attention_fwd_flash(q, k, v, mesh, axis, causal, inner, block,
                             dot=None):
    """Forward ring with a flash inner block; same contract as
    :func:`ring_attention_fwd`, out in q's dtype."""
    n = mesh.shape[axis]
    my = mesh.index(axis)
    b, h, sb, dh = q.shape
    kern_fwd, _ = _inner_kernels(inner, block, dot)
    out = torch.zeros((b, h, sb, dh), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sb), -torch.inf, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        kc, vc = k_cur, v_cur
        part = _ring_branches(
            causal, src, my,
            lambda: kern_fwd(q, kc, vc, True),
            lambda: kern_fwd(q, kc, vc, False),
            lambda: None)
        if part is not None:
            out, lse = _merge_partial(out, lse, *part)
        if step < n - 1:
            k_cur, v_cur = C.ppermute([k_cur, v_cur], mesh, axis)
    return out.to(q.dtype), lse


def ring_attention_bwd_flash(q, k, v, out, lse, dout, mesh, axis, causal,
                             inner, block, dot=None):
    """Backward ring with a flash inner block; same contract as
    :func:`ring_attention_bwd` (dk/dv accumulate in f32 while riding the
    ring a full circle home)."""
    n = mesh.shape[axis]
    my = mesh.index(axis)
    _, kern_bwd = _inner_kernels(inner, block, dot)
    # delta is a property of (out, dout) alone: computed once, not by
    # each of the ring's kernel calls
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
    k_cur, v_cur = k, v
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for step in range(n):
        src = (my - step) % n
        kc, vc = k_cur, v_cur
        part = _ring_branches(
            causal, src, my,
            lambda: kern_bwd(q, kc, vc, out, lse, dout, True, delta),
            lambda: kern_bwd(q, kc, vc, out, lse, dout, False, delta),
            lambda: None)
        if part is not None:
            dq_b, dk_b, dv_b = part
            dq = dq + dq_b.to(torch.float32)
            dk_cur = dk_cur + dk_b.to(torch.float32)
            dv_cur = dv_cur + dv_b.to(torch.float32)
        k_cur, v_cur, dk_cur, dv_cur = _backward_hop(
            step, n, mesh, axis, k_cur, v_cur, dk_cur, dv_cur)
    return dq.to(q.dtype), dk_cur.to(q.dtype), dv_cur.to(q.dtype)


def ring_self_attention(q, k, v, mesh, axis="seq", causal=True,
                        batch_axis=None, inner=None, block=128, dot=None):
    """Dense-equivalent attention with the sequence sharded over
    ``axis``: q/k/v are this rank's (B, H, S/n, dh) shards -> (out, lse)
    of its queries. ``batch_axis`` (SP × DP) needs nothing here: each
    data group's ranks ring among themselves, as the mesh's ``axis`` lines
    already are. ``inner``: None (fused dense block per ring step),
    "scan" or "pallas"; ``block`` is the scan's tile; ``dot`` the inner
    block's matmul (the dense block multiplies in its inputs' dtype, as
    the reference's)."""
    if inner is None:
        return ring_attention_fwd(q, k, v, mesh, axis, causal)
    return ring_attention_fwd_flash(q, k, v, mesh, axis, causal, inner,
                                    block, dot=dot)


def ring_self_attention_bwd(q, k, v, out, lse, dout, mesh, axis="seq",
                            causal=True, batch_axis=None, inner=None,
                            block=128, dot=None):
    """Backward of :func:`ring_self_attention` on this rank's shards ->
    (dq, dk, dv)."""
    if inner is None:
        return ring_attention_bwd(q, k, v, out, lse, dout, mesh, axis,
                                  causal)
    return ring_attention_bwd_flash(q, k, v, out, lse, dout, mesh, axis,
                                    causal, inner, block, dot=dot)
