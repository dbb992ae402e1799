"""The collectives of the port's distribution layer, each over one or more
named mesh axes.

The reference writes no collective by hand outside its ring: GSPMD
inserts the all-reduces of a sharded step, and the ring calls
``lax.ppermute``. Here every one is an explicit ``torch.distributed``
call over the process group of a mesh line (``Mesh.group``):

* :func:`all_reduce` (sum or max), :func:`all_gather`, :func:`broadcast`;
* :func:`ppermute` — the ring hop: each rank sends its tensors to the
  next rank of the axis and receives the previous rank's, as one batch
  of paired ``isend``/``irecv`` (``batch_isend_irecv``);
* :func:`all_to_all` — the expert exchange: chunk ``j`` of dim 0 goes to
  rank ``j`` of the axis, and the chunks received come back in rank
  order (``all_to_all_single``);
* :func:`hop` — the pipeline's tick: this rank's sends to and receives
  from its neighbours on the axis, only the ones the static schedule
  gives it, as one ``batch_isend_irecv`` (the peer posts the other side
  of each hop in the same tick).
* :func:`all_reduce_host` — a host tensor over every rank of the mesh on
  its gloo group, whatever the transport (the train loop's stop flags).

The transport is declared when the process group is made
(:func:`set_transport`), never chosen here:

* ``"nccl"`` — one rank per card; device tensors go to NCCL as they are;
* ``"gloo-host"`` — ranks that share a card (NCCL refuses two ranks on
  one GPU, and gloo's CUDA path lacks send/recv and all-to-all): each
  call copies its device tensors to the host, runs gloo there and copies
  the result back, while every kernel stays on the card;
* ``"gloo"`` — CPU ranks (the tests, ``-d cpu``): the tensors are host
  tensors already.

A tensor on another device than the transport takes raises
(:func:`all_reduce_host` takes host tensors only).

Each call is counted under the reference's HLO opcode names
(``all-reduce``, ``all-gather``, ``all-to-all``, ``collective-permute`` —
one per tensor moved, as one ``lax.ppermute`` is one HLO op; a pipeline
hop counts its sends — and ``broadcast``), with
its bytes and its host seconds. :func:`step_window` brackets one train
step: the step's counts are what ``parallel.collective_counts`` reports
(and its bytes ``TorchStep.collective_bytes``),
the port's hardware-free proof that a mode distributes work.
"""

import collections
import contextlib
import time

import torch
import torch.distributed as dist

#: the declared transport of this process's group (``set_transport``)
TRANSPORTS = ("nccl", "gloo-host", "gloo")
_transport = None

#: {opcode: calls}, {opcode: bytes} and {opcode: host seconds} since the
#: process started
counts = collections.Counter()
nbytes = collections.Counter()
seconds = collections.Counter()


def set_transport(name):
    """Declare the transport of this process's collectives."""
    global _transport
    if name not in TRANSPORTS:
        raise ValueError("transport must be one of %s, got %r"
                         % (TRANSPORTS, name))
    _transport = name


def transport():
    """The declared transport; raises before :func:`set_transport`."""
    if _transport is None:
        raise RuntimeError("no transport declared: the process group was "
                           "not made by parallel.init_multihost")
    return _transport


@contextlib.contextmanager
def step_window(into, bytes_into=None):
    """Count the collectives issued inside the block into the dict
    ``into`` (cleared first): {opcode: calls}; and, given, their bytes
    into ``bytes_into``: {opcode: bytes}."""
    before = collections.Counter(counts)
    before_bytes = collections.Counter(nbytes)
    try:
        yield into
    finally:
        into.clear()
        into.update({op: n - before[op] for op, n in counts.items()
                     if n - before[op]})
        if bytes_into is not None:
            bytes_into.clear()
            bytes_into.update({op: n - before_bytes[op]
                               for op, n in nbytes.items()
                               if n - before_bytes[op]})


def _account(op, tensors, t0, calls=1):
    counts[op] += calls
    nbytes[op] += sum(t.numel() * t.element_size() for t in tensors)
    seconds[op] += time.perf_counter() - t0


def _check(tensors):
    mode = transport()
    for t in tensors:
        on_host = t.device.type == "cpu"
        if mode == "gloo" and not on_host:
            raise ValueError("transport 'gloo' moves host tensors; got one "
                             "on %s" % t.device)
        if mode != "gloo" and on_host:
            raise ValueError("transport %r moves card tensors; got one on "
                             "the host" % mode)
    return mode


def _host(tensors, mode):
    """The tensors the transport hands to torch.distributed."""
    if mode == "gloo-host":
        return [t.detach().to("cpu") for t in tensors]
    return [t.detach().contiguous() for t in tensors]


def _pack(tensors):
    """The tensors' bytes, one after another, in one uint8 tensor."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _unpack(flat, like):
    """The tensors shaped as ``like`` from :func:`_pack`'s bytes."""
    out, pos = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[pos:pos + n].view(t.dtype).view(t.shape))
        pos += n
    return out


def all_reduce(tensor, mesh, axes, op="sum"):
    """-> ``tensor`` summed (or maxed) over the ranks of this rank's line
    of ``axes`` (a new tensor on ``tensor``'s device; the input is left
    as it is). One call, counted as ``all-reduce``."""
    group, size = mesh.group(axes)
    if size == 1:
        return tensor
    mode = _check([tensor])
    t0 = time.perf_counter()
    (buf,) = _host([tensor], mode)
    if buf.data_ptr() == tensor.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    out = buf.to(tensor.device)
    _account("all-reduce", [tensor], t0)
    return out


def all_reduce_host(tensor, mesh):
    """-> the host tensor ``tensor`` summed over every rank of the mesh on
    its gloo group (``mesh.host_group``), whatever the transport: no card
    work, so nothing waits for the card's queue. One call, counted as
    ``all-reduce``."""
    if tensor.device.type != "cpu":
        raise ValueError("all_reduce_host moves host tensors; got one on "
                         "%s" % tensor.device)
    if mesh.host_group is None:
        raise RuntimeError("mesh %s has no host group (made by make_mesh)"
                           % dict(mesh.shape))
    t0 = time.perf_counter()
    buf = tensor.detach().clone()
    dist.all_reduce(buf, group=mesh.host_group)
    _account("all-reduce", [tensor], t0)
    return buf


def all_gather(tensor, mesh, axes):
    """-> [the tensor of each rank of this rank's line of ``axes``], in
    the line's rank order. One call, counted as ``all-gather``."""
    group, size = mesh.group(axes)
    if size == 1:
        return [tensor]
    mode = _check([tensor])
    t0 = time.perf_counter()
    (buf,) = _host([tensor], mode)
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    out = [p.to(tensor.device) for p in parts]
    _account("all-gather", [tensor], t0)
    return out


def broadcast(tensor, mesh, axes):
    """-> the tensor of the first rank of this rank's line of ``axes`` (a
    new tensor). One call, counted as ``broadcast``."""
    group, size = mesh.group(axes)
    if size == 1:
        return tensor
    mode = _check([tensor])
    t0 = time.perf_counter()
    (buf,) = _host([tensor], mode)
    if buf.data_ptr() == tensor.data_ptr():
        buf = buf.clone()
    dist.broadcast(buf, src=mesh.line(axes)[0], group=group)
    out = buf.to(tensor.device)
    _account("broadcast", [tensor], t0)
    return out


def ppermute(tensors, mesh, axis, shift=1):
    """The ring hop over ``axis``: this rank's ``tensors`` go to the rank
    ``shift`` places on along the axis, and the tensors of the rank
    ``shift`` places back come here -> the received tensors (same
    shapes and dtypes). Their bytes go as one send and one receive; counted as
    one ``collective-permute`` per tensor, as the reference's HLO has one
    op per ``lax.ppermute``."""
    group, size = mesh.group((axis,))
    if size == 1:
        return list(tensors)
    mode = _check(tensors)
    t0 = time.perf_counter()
    line = mesh.line((axis,))
    me = mesh.index(axis)
    send = _pack(_host(tensors, mode))
    recv = torch.empty_like(send)
    # one batch: under NCCL, unbatched sends would each set up a 2-rank
    # communicator, whose set-up waits on the peer's own first send: a
    # cycle round the ring
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, line[(me + shift) % size], group),
            dist.P2POp(dist.irecv, recv, line[(me - shift) % size],
                       group)]):
        req.wait()
    out = [t.to(tensors[0].device) for t in _unpack(recv, tensors)]
    _account("collective-permute", tensors, t0, calls=len(tensors))
    return out


def all_to_all(tensor, mesh, axis):
    """The all-to-all over ``axis``: dim 0 of ``tensor`` (a multiple of the
    axis size n) is cut into n equal chunks, chunk ``j`` goes to rank
    ``j`` of the axis, and the result holds, in the same place, the
    chunks this rank received, in the axis' rank order (a new tensor).
    One call, counted as ``all-to-all``."""
    group, size = mesh.group((axis,))
    if size == 1:
        return tensor
    if tensor.shape[0] % size:
        raise ValueError("all_to_all over %s (%d ranks): dim 0 is %d"
                         % (axis, size, tensor.shape[0]))
    mode = _check([tensor])
    t0 = time.perf_counter()
    (buf,) = _host([tensor], mode)
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    out = out.to(tensor.device)
    _account("all-to-all", [tensor], t0)
    return out


def hop(mesh, axis, sends=(), recvs=()):
    """One tick of the pipeline over ``axis``: ``sends`` is [(shift,
    tensor)], each tensor going to the rank ``shift`` (±1) places on;
    ``recvs`` is [(shift, shape, dtype, device)], each tensor received
    from the rank ``shift`` places on -> the received tensors, on
    ``device``. Every op of the tick goes in ONE ``batch_isend_irecv``
    (under ``gloo-host`` through host buffers); the peer of each op
    posts the other side in the same tick. Counted as one
    ``collective-permute`` per tensor sent, with its bytes."""
    if not sends and not recvs:
        return []
    group, _ = mesh.group((axis,))
    mode = transport()
    t0 = time.perf_counter()
    line = mesh.line((axis,))
    me = mesh.index(axis)
    ops, out = [], []
    for shift, t in sends:
        _check([t])
        (buf,) = _host([t], mode)
        ops.append(dist.P2POp(dist.isend, buf.contiguous(),
                              line[me + shift], group))
    for shift, shape, dtype, dev in recvs:
        where = "cpu" if mode != "nccl" else dev
        buf = torch.empty(shape, dtype=dtype, device=where)
        ops.append(dist.P2POp(dist.irecv, buf, line[me + shift], group))
        out.append((buf, dev))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = [buf.to(dev) for buf, dev in out]
    if sends:
        _account("collective-permute", [t for _, t in sends], t0,
                 calls=len(sends))
    return got
