"""Flash attention: exact softmax attention with its row logsumexp, and
its backward from that logsumexp, fused or as two kernels.

Replaces the Pallas TPU kernels of
``veles/znicz_tpu/parallel/pallas_attention.py``: ``_fwd_kernel``
(``flash_attention_fwd``), ``_fwd_kernel_pipe`` (``pipeline=True``),
``_dkvq_kernel`` (``flash_attention_bwd``, ``fused=True``), and
``_dq_kernel`` + ``_dkv_kernel`` (``fused=False``, here also callable
one at a time as :func:`flash_attention_dq` and
:func:`flash_attention_dkv`). The public functions keep the JAX
signatures and the (B, H, S, dh) layout. On the card the work goes to
the hand-written CUDA kernels in ``veles_torch/csrc/`` (for bf16 inputs
``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu`` — the fused backward and,
without dq, the dk/dv kernel — and ``flash_dq_sm90.cu``; for f32 inputs
``flash_attention.cu``); on the CPU to the ``*_plain`` versions, dense
softmax attention under the kernels' dtype rules: f32 scores, exp and
lse; p rounded to the storage dtype before the PV product; ds rounded
likewise before the dk/dq products; f32 accumulation.

bf16 inputs (the card's compute dtype) run the block products on the
tensor cores, on ``wgmma`` with TMA loads; f32 inputs run scalar f32
FMAs. What bounds them on an H100, and what the kernels do about it, is
noted in the CUDA sources. Tiles are the port's own (64 x 64 for every
dh in f32; in bf16 the forward and the dq kernel 128 query rows x 128
keys (the dq kernel 64 keys at dh 128), the fused backward and the dk/dv
kernel 128 keys x 64 queries); the JAX ``block_q``/``block_k`` are
VMEM-sized and not carried over. The kernels are built for head dims
16, 32, 64 and 128; any other dh up to 128 runs zero-padded to the next
of them (:func:`kernel_head_dim`), and the plain versions take any dh,
as the reference does.
"""

import ctypes

import numpy
import torch

from veles_torch import kernels, perf

#: head dims the kernels are built for; a smaller one runs zero-padded to
#: the next of them (:func:`kernel_head_dim`)
HEAD_DIMS = (16, 32, 64, 128)
#: query rows / key rows per tile (``kBQ`` / ``kBK`` in the CUDA source)
BLOCK_Q = BLOCK_K = 64
#: keys per work item of the bf16 fused backward (``kBK`` in
#: csrc/flash_bwd_sm90.cu; its Q tiles are BLOCK_Q rows), and per K tile
#: of the bf16 forward (csrc/flash_fwd_sm90.cu)
SM90_BLOCK_K = 128
#: query rows per work item of the bf16 forward and dq kernel (``kBQ`` in
#: csrc/flash_fwd_sm90.cu and csrc/flash_dq_sm90.cu)
SM90_FWD_BLOCK_Q = 128
#: causal mask value of the TPU kernels
MASK_VALUE = -1e9
#: most bytes the backward's per-chunk f32 dq partials may take
DQ_PARTIAL_CAP = 1 << 30
#: score-matrix elements a plain-version chunk of b*h rows may hold
PLAIN_CHUNK_ELEMS = 1 << 28
#: the work of each kernel, reported to the cost counter (``perf.py``):
#: block products as multiples of B·H·S²·dh (each 2·S²·dh operations;
#: causal: half of them), (B, H, S, dh) tensors and f32 (B, H, S) rows
#: written
WORK = {"fwd": (4, 1, 1), "bwd": (10, 3, 0), "dq": (6, 1, 0),
        "dkv": (8, 2, 0)}
#: dtype -> code of ``enum DType`` in csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "veles_flash_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
    "veles_flash_bwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
    "veles_flash_bwd_dq": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
    "veles_flash_bwd_dkv": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
    "veles_flash_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_SM90_SIGNATURES = {
    "veles_flash_bwd_sm90": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]),
    "veles_flash_dkv_sm90": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
    "veles_flash_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_SM90_DQ_SIGNATURES = {
    "veles_flash_dq_sm90": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]),
    "veles_flash_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_SM90_FWD_SIGNATURES = {
    "veles_flash_fwd_sm90": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]),
    "veles_flash_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def scale_for(dh):
    """The softmax scale 1/sqrt(dh), rounded to float32 as the
    reference's."""
    return float(numpy.float32(1.0 / numpy.sqrt(dh)))


def kernel_head_dim(dh):
    """The head dim the kernels run a ``dh``-wide head at: the smallest
    of HEAD_DIMS that holds it. The wrappers zero-pad q, k, v (and dout)
    to it and pass the scale of the true ``dh``: zero columns change
    neither q·kᵀ nor the first ``dh`` columns of out, dq, dk or dv, which
    are sliced back. Raises above the widest built head dim."""
    for built in HEAD_DIMS:
        if dh <= built:
            return built
    raise ValueError(
        "head dim %d: the kernels take head dims up to %d (wider heads are "
        "ROADMAP Queue 2b item 5)" % (dh, HEAD_DIMS[-1]))


def _widen(tensors, dh):
    """``tensors`` zero-padded along the head dim to ``dh`` columns."""
    return [t if t.shape[-1] == dh else
            torch.nn.functional.pad(t, (0, dh - t.shape[-1]))
            for t in tensors]


def _narrow(t, dh):
    """The first ``dh`` columns of a padded kernel output, contiguous."""
    return t if t.shape[-1] == dh else t[..., :dh].contiguous()


# -- launch plans (mirror the loops of the CUDA kernels) ------------------


def n_tiles(s, block=BLOCK_Q):
    return -(-s // block)


def fwd_k_tiles(s, qt, causal):
    """K tiles the forward CTA of Q tile ``qt`` visits: ``(hi, clear)``
    — tiles ``[0, hi)``, of which those ``>= clear`` may hold a masked
    column (the diagonal)."""
    n_kt = n_tiles(s, BLOCK_K)
    if not causal:
        return n_kt, n_kt
    q0 = qt * BLOCK_Q
    return min(n_kt, -(-(q0 + BLOCK_Q) // BLOCK_K)), q0 // BLOCK_K


def fwd_sm90_plan(bh, s, causal, pipe, block_k=SM90_BLOCK_K):
    """The bf16 forward's work items (csrc/flash_fwd_sm90.cu) in order:
    ``[(b, qt, [(kt, masked), ...]), ...]``, one per (b*h, Q tile of
    SM90_FWD_BLOCK_Q rows), Q tiles longest first and the heads in turn,
    each over its K tiles of ``block_k`` keys: up to the diagonal when
    causal. ``pipe=False`` masks the tiles from the diagonal on and the
    ragged last K tile; ``pipe=True`` every visited tile."""
    n_qt = n_tiles(s, SM90_FWD_BLOCK_Q)
    n_kt = n_tiles(s, block_k)
    edge = n_kt - 1 if s % block_k else None
    ratio = SM90_FWD_BLOCK_Q // block_k
    plan = []
    for qt in reversed(range(n_qt)):
        hi, clear = ((min(n_kt, ratio * (qt + 1)), ratio * qt) if causal
                     else (n_kt, n_kt))
        for b in range(bh):
            plan.append((b, qt, [(kt, pipe or kt >= clear or kt == edge)
                                 for kt in range(hi)]))
    return plan


def fwd_sm90_deal(n_items, grid):
    """The items of :func:`fwd_sm90_plan` each CTA of the persistent
    forward takes, in order (``Deal`` in csrc/flash_fwd_sm90.cu): rounds
    of one item per CTA, every other round in reverse."""
    deal = [[] for _ in range(grid)]
    for i in range(n_items):
        r, x = divmod(i, grid)
        deal[grid - 1 - x if r % 2 else x].append(i)
    return deal


def dq_sm90_block_k(dh):
    """Keys per K tile of the bf16 dq kernel (``kBK`` in
    csrc/flash_dq_sm90.cu) at kernel head dim ``dh``: 64 at dh 128, where
    the S, dP and dq accumulators of 128 keys would not fit the
    registers, else SM90_BLOCK_K."""
    return 64 if dh == 128 else SM90_BLOCK_K


def dq_sm90_plan(bh, s, causal, dh):
    """The bf16 dq kernel's work items (csrc/flash_dq_sm90.cu) in order,
    as :func:`fwd_sm90_plan` without the pipeline, whose items and masks
    it follows, over K tiles of :func:`dq_sm90_block_k` keys; the items
    go to the CTAs by :func:`fwd_sm90_deal`."""
    return fwd_sm90_plan(bh, s, causal, False,
                         dq_sm90_block_k(kernel_head_dim(dh)))


def bwd_chunks(bh, s, dh):
    """Chunk count of the fused backward: one per K tile, fewer when the
    f32 dq partials (chunks x b*h x S x dh) would pass DQ_PARTIAL_CAP."""
    slot = 4 * bh * s * dh
    return max(1, min(n_tiles(s, BLOCK_K), DQ_PARTIAL_CAP // slot))


def bwd_pairs(s, chunk, n_chunks, causal):
    """The (k tile, q tile) pairs the backward CTA of ``chunk`` visits,
    in order: K tiles ``chunk, chunk + n_chunks, ...``, each over Q
    tiles from the diagonal (causal) or from 0."""
    n_kt, n_qt = n_tiles(s, BLOCK_K), n_tiles(s, BLOCK_Q)
    return [(kt, qt) for kt in range(chunk, n_kt, n_chunks)
            for qt in range((kt * BLOCK_K) // BLOCK_Q if causal else 0,
                            n_qt)]


def dq_chunks(row, n_chunks, causal):
    """Chunks whose dq partial holds ``row`` (summed by ``dq_reduce``)."""
    return range(min(n_chunks, row // BLOCK_Q + 1) if causal
                 else n_chunks)


def dq_plan(s, qt, causal):
    """The (K tile, masked) pairs the f32 dq kernel's CTA of Q tile
    ``qt`` visits, in order: the forward's K tiles, the mask on the tail
    ``>= clear`` and on the ragged last K tile (padded columns)."""
    hi, clear = fwd_k_tiles(s, qt, causal)
    last = n_tiles(s, BLOCK_K) - 1 if s % BLOCK_K else None
    return [(kt, kt >= clear or kt == last) for kt in range(hi)]


def dkv_plan(s, kt, causal):
    """The (Q tile, masked) pairs the f32 dk/dv kernel's CTA of K tile
    ``kt`` visits, in order: Q tiles from the diagonal (causal) or from 0,
    the mask on the head ``< clear`` (the tiles that cross the diagonal)
    and on either ragged edge (padded rows or keys)."""
    n_qt = n_tiles(s, BLOCK_Q)
    k0 = kt * BLOCK_K
    lo, clear = ((k0 // BLOCK_Q, -(-(k0 + BLOCK_K - 1) // BLOCK_Q))
                 if causal else (0, 0))
    ragged = s % BLOCK_K != 0
    edge = ragged and kt == n_tiles(s, BLOCK_K) - 1
    return [(qt, qt < clear or edge or (ragged and qt == n_qt - 1))
            for qt in range(lo, n_qt)]


def bwd_sm90_plan(bh, s, causal):
    """The bf16 fused backward's work plan (csrc/flash_bwd_sm90.cu) ->
    ``(items, order)``. ``items``: the work items in ticket order, each
    ``(b, kt, [(qt, masked), ...])``: heads in turn, K tiles of
    SM90_BLOCK_K keys descending within a head, each over the Q tiles
    that attend it (from the diagonal when causal), masked on the tiles
    that cross the diagonal or hold a padded key or row. ``order[b,
    qt]``: the K tiles that add to that Q tile's dq, in the order its
    counter admits them: descending, the first stores without adding,
    the last (K tile 0) writes the bf16 dq."""
    ratio = SM90_BLOCK_K // BLOCK_Q
    n_kt, n_qt = n_tiles(s, SM90_BLOCK_K), n_tiles(s, BLOCK_Q)
    items = [(b, kt, _bwd_sm90_steps(s, kt, causal))
             for b in range(bh) for kt in reversed(range(n_kt))]
    order = {(b, qt): list(reversed(range(
        min(n_kt - 1, qt // ratio) + 1 if causal else n_kt)))
        for b in range(bh) for qt in range(n_qt)}
    return items, order


def _bwd_sm90_steps(s, kt, causal):
    """The (Q tile, masked) steps of the bf16 backward's item of K tile
    ``kt``: the Q tiles that attend it (from the diagonal when causal),
    masked on those that cross the diagonal or hold a padded key or
    row."""
    ratio = SM90_BLOCK_K // BLOCK_Q
    n_kt, n_qt = n_tiles(s, SM90_BLOCK_K), n_tiles(s, BLOCK_Q)
    edge_k = n_kt - 1 if s % SM90_BLOCK_K else None
    edge_q = n_qt - 1 if s % BLOCK_Q else None
    return [(qt, (causal and qt < ratio * (kt + 1)) or kt == edge_k
             or qt == edge_q)
            for qt in range(ratio * kt if causal else 0, n_qt)]


def dkv_sm90_plan(bh, s, causal):
    """The bf16 dk/dv kernel's work items (csrc/flash_bwd_sm90.cu without
    dq) in order: ``[(b, kt, [(qt, masked), ...]), ...]``, the fused
    backward's items (:func:`bwd_sm90_plan`) with no ticket: K tiles
    ascending (the longest causal items first) and the heads in turn,
    dealt to the CTAs by :func:`fwd_sm90_deal`."""
    return [(b, kt, _bwd_sm90_steps(s, kt, causal))
            for kt in range(n_tiles(s, SM90_BLOCK_K)) for b in range(bh)]


# -- plain versions -------------------------------------------------------


def _causal_mask(s, device):
    idx = torch.arange(s, device=device)
    return idx[None, :] > idx[:, None]


def _chunks(bh, s):
    step = max(1, PLAIN_CHUNK_ELEMS // (s * s))
    return [slice(i, min(i + step, bh)) for i in range(0, bh, step)]


def flash_attention_fwd_plain(q, k, v, causal=True, acc_dtype=None):
    """Dense softmax attention over (B, H, S, dh) -> (out in q.dtype,
    lse f32 (B, H, S)), in the kernels' dtype rules; the b*h rows go in
    chunks so the (S, S) scores stay bounded. ``acc_dtype`` bf16 rounds
    the PV product to bf16 before the normalisation."""
    b, h, s, dh = q.shape
    scale = scale_for(dh)
    qf, kf, vf = (t.reshape(b * h, s, dh) for t in (q, k, v))
    out = torch.empty((b * h, s, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    mask = _causal_mask(s, q.device) if causal else None
    for sl in _chunks(b * h, s):
        sc = torch.matmul(qf[sl].float(),
                          kf[sl].float().transpose(1, 2)) * scale
        if causal:
            sc = sc.masked_fill(mask, MASK_VALUE)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        del sc
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(q.dtype).float(), vf[sl].float())
        if acc_dtype == torch.bfloat16:
            pv = pv.to(torch.bfloat16).float()
        out[sl] = (pv / l).to(q.dtype)
        lse[sl] = (m + torch.log(l)).squeeze(-1)
    return out.reshape(b, h, s, dh), lse.reshape(b, h, s)


def _bwd_plain(q, k, v, out, lse, dout, causal, delta, parts):
    """The gradients named in ``parts`` (of "dq", "dk", "dv"), in q.dtype,
    in the kernels' dtype rules; each one's arithmetic is the same
    whichever others are asked for."""
    b, h, s, dh = q.shape
    scale = scale_for(dh)
    if delta is None:
        delta = row_delta(out, dout)
    flat = [t.reshape(b * h, s, dh) for t in (q, k, v, dout)]
    lsef = lse.reshape(b * h, s, 1).float()
    deltaf = delta.reshape(b * h, s, 1).float()
    grads = {name: torch.empty((b * h, s, dh), dtype=q.dtype,
                               device=q.device) for name in parts}
    mask = _causal_mask(s, q.device) if causal else None
    for sl in _chunks(b * h, s):
        qf, kf, vf, dof = (t[sl].float() for t in flat)
        sc = torch.matmul(qf, kf.transpose(1, 2)) * scale
        if causal:
            sc = sc.masked_fill(mask, MASK_VALUE)
        p = torch.exp(sc - lsef[sl])
        del sc
        if "dv" in grads:
            grads["dv"][sl] = torch.matmul(
                p.to(q.dtype).float().transpose(1, 2), dof).to(q.dtype)
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = (p * (dp - deltaf[sl]) * scale).to(q.dtype).float()
        del p, dp
        if "dq" in grads:
            grads["dq"][sl] = torch.matmul(ds, kf).to(q.dtype)
        if "dk" in grads:
            grads["dk"][sl] = torch.matmul(ds.transpose(1, 2),
                                           qf).to(q.dtype)
    return tuple(grads[name].reshape(b, h, s, dh) for name in parts)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True,
                              delta=None):
    """Backward of :func:`flash_attention_fwd_plain` from the saved lse
    -> (dq, dk, dv) in q.dtype, in the kernels' dtype rules."""
    return _bwd_plain(q, k, v, out, lse, dout, causal, delta,
                      ("dq", "dk", "dv"))


def flash_attention_dq_plain(q, k, v, out, lse, dout, causal=True,
                             delta=None):
    """dq of :func:`flash_attention_bwd_plain`, alone."""
    return _bwd_plain(q, k, v, out, lse, dout, causal, delta, ("dq",))[0]


def flash_attention_dkv_plain(q, k, v, out, lse, dout, causal=True,
                              delta=None):
    """(dk, dv) of :func:`flash_attention_bwd_plain`, alone."""
    return _bwd_plain(q, k, v, out, lse, dout, causal, delta, ("dk", "dv"))


def row_delta(out, dout):
    """``rowsum(dout·out)`` in f32 — a plain op outside the kernel, as in
    ``pallas_attention.flash_attention_bwd``."""
    return (dout.float() * out.float()).sum(dim=-1)


# -- the wrappers ---------------------------------------------------------


def _check(name, tensors):
    """Shape checks for every device; -> True when the kernel runs (CUDA
    tensors, at a head dim :func:`kernel_head_dim` takes), False for the
    plain version (CPU tensors, any head dim)."""
    shape = tuple(tensors[0].shape)
    if len(shape) != 4:
        raise ValueError("%s: q must be (B, H, S, dh), got %s"
                         % (name, shape))
    for t in tensors:
        if tuple(t.shape) != shape:
            raise ValueError("%s: shapes %s differ" % (
                name, [tuple(x.shape) for x in tensors]))
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or len(devices) != 1:
        raise ValueError("%s: the kernel needs every input on one CUDA "
                         "device, got %s" % (name, sorted(map(str, devices))))
    kernel_head_dim(shape[3])
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError("%s kernel takes one of %s for all inputs, got %s"
                        % (name, sorted(map(str, _DTYPE_CODES)),
                           [t.dtype for t in tensors]))
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s kernel needs contiguous, 16-byte aligned "
                             "inputs" % name)
    return True


def kernel_cost(form, shape, causal, dtype):
    """-> (flops, bytes written) of one launch of ``form``'s kernel (a key
    of :data:`WORK`) on (B, H, S, dh) inputs of ``dtype``: its block
    products, only the causal half of them when ``causal``."""
    b, h, s, dh = shape
    products, tensors, rows = WORK[form]
    flops = products * b * h * s * s * dh / (2 if causal else 1)
    nbytes = (tensors * b * h * s * dh * dtype.itemsize
              + rows * b * h * s * 4)
    return flops, nbytes


def _report(name, form, shape, causal, dtype):
    """The launch's work to the active cost counter (``perf.py``): the
    bf16 kernels' products run at the bf16 rate, the f32 ones' as scalar
    f32."""
    flops, nbytes = kernel_cost(form, shape, causal, dtype)
    perf.add_kernel_cost(name, flops, nbytes,
                         "bf16" if dtype == torch.bfloat16 else "f32")


def _raise_on(lib, rc, name):
    if rc:
        raise RuntimeError("%s kernel launch failed: %s (%d)" % (
            name, lib.veles_flash_error_string(rc).decode(), rc))


def flash_attention_fwd(q, k, v, causal=True, pipeline=False,
                        acc_dtype=None):
    """q/k/v: (B, H, S, dh) -> (out in q.dtype, lse (B, H, S) f32),
    exact. ``pipeline=True`` takes ``_fwd_kernel_pipe``'s counterpart,
    which masks every visited tile; ``acc_dtype=torch.bfloat16`` narrows
    the PV accumulation chain (the ``attn_acc="bf16"`` experiment). CUDA
    tensors go to the kernels (bf16: the wgmma kernel of
    csrc/flash_fwd_sm90.cu; f32: the scalar one of flash_attention.cu), or
    this raises; CPU tensors to :func:`flash_attention_fwd_plain`."""
    if acc_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("acc_dtype must be None, float32 or bfloat16, "
                         "got %r" % (acc_dtype,))
    if not _check("flash_attention_fwd", (q, k, v)):
        return flash_attention_fwd_plain(q, k, v, causal, acc_dtype)
    b, h, s, dh = q.shape
    kdh = kernel_head_dim(dh)
    q, k, v = _widen((q, k, v), kdh)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    acc_bf16 = int(acc_dtype == torch.bfloat16)
    if q.dtype == torch.bfloat16:
        lib = kernels.load("flash_fwd_sm90", _SM90_FWD_SIGNATURES)
        rc = lib.veles_flash_fwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, kdh, int(causal), int(pipeline),
            acc_bf16, scale_for(dh), stream)
    else:
        lib = kernels.load("flash_attention", _SIGNATURES)
        rc = lib.veles_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, kdh, _DTYPE_CODES[q.dtype],
            int(causal), int(pipeline), acc_bf16, scale_for(dh), stream)
    _raise_on(lib, rc, "flash_attention_fwd")
    variant = "fwd_pipe" if pipeline else "fwd"
    flash_attention_fwd.launches += 1
    flash_attention_fwd.variant_launches[variant] += 1
    flash_attention_fwd.mask_launches["causal" if causal else "full"] += 1
    _report("flash_" + variant, "fwd", (b, h, s, dh), causal, q.dtype)
    return _narrow(out, dh), lse


def _bwd_args(name, q, k, v, out, lse, dout, delta):
    """The backward kernels' checks; -> (True, f32 delta) when the kernel
    runs (CUDA tensors), (False, ``delta``) for the plain version."""
    if not _check(name, (q, k, v, out, dout)):
        return False, delta
    b, h, s, _ = q.shape
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("%s: lse must be contiguous float32 (B, H, S) on "
                         "%s" % (name, q.device))
    delta = row_delta(out, dout) if delta is None \
        else delta.to(torch.float32).contiguous()
    if tuple(delta.shape) != (b, h, s) or delta.device != q.device:
        raise ValueError("%s: delta must be (B, H, S) on %s"
                         % (name, q.device))
    return True, delta


def _launched(variant, shape, causal, dtype):
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[variant] += 1
    flash_attention_bwd.mask_launches["causal" if causal else "full"] += 1
    _report("flash_bwd_" + variant, "bwd" if variant == "fused" else variant,
            shape, causal, dtype)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, delta=None,
                        fused=True):
    """Block-recomputation backward from the saved lse -> (dq, dk, dv)
    in q.dtype, exact. ``delta``: optional precomputed
    ``rowsum(dout·out)`` (B, H, S). ``fused=True`` runs the single-pass
    kernel (``_dkvq_kernel``'s counterpart: for bf16 the wgmma kernel of
    csrc/flash_bwd_sm90.cu, dq summed in a fixed order in one f32
    workspace; for f32 the chunked kernel and its dq partials);
    ``fused=False`` the dq kernel and the dk/dv kernel
    (:func:`flash_attention_dq`, :func:`flash_attention_dkv`), which
    recompute the scores in each. CUDA tensors go to the kernels (or this
    raises), CPU tensors to the plain versions."""
    if not fused:
        if delta is None:
            delta = row_delta(out, dout)
        return (flash_attention_dq(q, k, v, out, lse, dout, causal, delta),
                *flash_attention_dkv(q, k, v, out, lse, dout, causal, delta))
    on_card, delta = _bwd_args("flash_attention_bwd", q, k, v, out, lse,
                               dout, delta)
    if not on_card:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         delta)
    b, h, s, dh = q.shape
    kdh = kernel_head_dim(dh)
    q, k, v, dout = _widen((q, k, v, dout), kdh)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        n_qt = n_tiles(s, BLOCK_Q)
        dq_acc = torch.empty((b * h, n_qt * BLOCK_Q, kdh),
                             dtype=torch.float32, device=q.device)
        # the ticket, then one counter per (b*h, Q tile)
        sync = torch.zeros(1 + b * h * n_qt, dtype=torch.int32,
                           device=q.device)
        lib = kernels.load("flash_bwd_sm90", _SM90_SIGNATURES)
        rc = lib.veles_flash_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_acc.data_ptr(), sync.data_ptr(), b * h, s, kdh,
            int(causal), scale_for(dh), stream)
        _raise_on(lib, rc, "flash_attention_bwd")
        _launched("fused", (b, h, s, dh), causal, q.dtype)
        return tuple(_narrow(t, dh) for t in (dq, dk, dv))
    n_chunks = bwd_chunks(b * h, s, kdh)
    partial = torch.empty((n_chunks, b * h, s, kdh), dtype=torch.float32,
                          device=q.device)
    lib = kernels.load("flash_attention", _SIGNATURES)
    rc = lib.veles_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), partial.data_ptr(), b * h, s, kdh,
        _DTYPE_CODES[q.dtype], int(causal), n_chunks, scale_for(dh), stream)
    _raise_on(lib, rc, "flash_attention_bwd")
    _launched("fused", (b, h, s, dh), causal, q.dtype)
    return tuple(_narrow(t, dh) for t in (dq, dk, dv))


def flash_attention_dq(q, k, v, out, lse, dout, causal=True, delta=None):
    """dq of the backward, by the dq kernel (``_dq_kernel``'s
    counterpart: each Q tile over the K tiles it attends; for bf16 the
    wgmma kernel of csrc/flash_dq_sm90.cu, for f32 the scalar one) on
    CUDA tensors, or :func:`flash_attention_dq_plain` on CPU tensors."""
    on_card, delta = _bwd_args("flash_attention_dq", q, k, v, out, lse,
                               dout, delta)
    if not on_card:
        return flash_attention_dq_plain(q, k, v, out, lse, dout, causal,
                                        delta)
    b, h, s, dh = q.shape
    kdh = kernel_head_dim(dh)
    q, k, v, dout = _widen((q, k, v, dout), kdh)
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, s, kdh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        lib = kernels.load("flash_dq_sm90", _SM90_DQ_SIGNATURES)
        rc = lib.veles_flash_dq_sm90(*args, int(causal), scale_for(dh),
                                     stream)
    else:
        lib = kernels.load("flash_attention", _SIGNATURES)
        rc = lib.veles_flash_bwd_dq(*args, _DTYPE_CODES[q.dtype],
                                    int(causal), scale_for(dh), stream)
    _raise_on(lib, rc, "flash_attention_dq")
    _launched("dq", (b, h, s, dh), causal, q.dtype)
    return _narrow(dq, dh)


def flash_attention_dkv(q, k, v, out, lse, dout, causal=True, delta=None):
    """(dk, dv) of the backward, by the dk/dv kernel (``_dkv_kernel``'s
    counterpart: each K tile over the Q tiles that attend it; for bf16
    the fused wgmma kernel of csrc/flash_bwd_sm90.cu without dq, whose dk
    and dv it equals bit for bit, for f32 the scalar one) on CUDA
    tensors, or :func:`flash_attention_dkv_plain` on CPU tensors."""
    on_card, delta = _bwd_args("flash_attention_dkv", q, k, v, out, lse,
                               dout, delta)
    if not on_card:
        return flash_attention_dkv_plain(q, k, v, out, lse, dout, causal,
                                         delta)
    b, h, s, dh = q.shape
    kdh = kernel_head_dim(dh)
    q, k, v, dout = _widen((q, k, v, dout), kdh)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, s, kdh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        lib = kernels.load("flash_bwd_sm90", _SM90_SIGNATURES)
        rc = lib.veles_flash_dkv_sm90(*args, int(causal), scale_for(dh),
                                      stream)
    else:
        lib = kernels.load("flash_attention", _SIGNATURES)
        rc = lib.veles_flash_bwd_dkv(*args, _DTYPE_CODES[q.dtype],
                                     int(causal), scale_for(dh), stream)
    _raise_on(lib, rc, "flash_attention_dkv")
    _launched("dkv", (b, h, s, dh), causal, q.dtype)
    return _narrow(dk, dh), _narrow(dv, dh)


def reset_launches():
    """Set every launch count of this module to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.variant_launches = {"fwd": 0, "fwd_pipe": 0}
    flash_attention_fwd.mask_launches = {"causal": 0, "full": 0}
    flash_attention_bwd.launches = 0
    flash_attention_bwd.variant_launches = {"fused": 0, "dq": 0, "dkv": 0}
    flash_attention_bwd.mask_launches = {"causal": 0, "full": 0}


#: kernel launches: forward and backward, each in all, by variant and by
#: mask (causal or full: the ring runs both)
reset_launches()
