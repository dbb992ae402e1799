"""The collectives of the port's distribution layer, each over one or more
named mesh axes.

The reference writes no collective by hand outside its ring: GSPMD
inserts the all-reduces of a sharded step, and the ring calls
``lax.ppermute``. Here every one is an explicit ``torch.distributed``
call over the process group of a mesh line (``Mesh.group``):

* :func:`all_reduce` (sum or max), :func:`all_gather`, :func:`broadcast`;
* :func:`ppermute` — the ring hop: each rank sends its tensors to the
  next rank of the axis and receives the previous rank's, as one batch
  of paired ``isend``/``irecv`` (``batch_isend_irecv``).

The transport is declared when the process group is made
(:func:`set_transport`), never chosen here:

* ``"nccl"`` — one rank per card; device tensors go to NCCL as they are;
* ``"gloo-host"`` — ranks that share a card (NCCL refuses two ranks on
  one GPU, and gloo's CUDA path lacks send/recv and all-to-all): each
  call copies its device tensors to the host, runs gloo there and copies
  the result back, while every kernel stays on the card;
* ``"gloo"`` — CPU ranks (the tests, ``-d cpu``): the tensors are host
  tensors already.

A tensor on another device than the transport takes raises.

Each call is counted under the reference's HLO opcode names
(``all-reduce``, ``all-gather``, ``collective-permute`` — one per tensor
moved, as one ``lax.ppermute`` is one HLO op — and ``broadcast``), with
its bytes and its host seconds. :func:`step_window` brackets one train
step: the step's counts are what ``parallel.collective_counts`` reports,
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
def step_window(into):
    """Count the collectives issued inside the block into the dict
    ``into`` (cleared first): {opcode: calls}."""
    before = collections.Counter(counts)
    try:
        yield into
    finally:
        into.clear()
        into.update({op: n - before[op] for op, n in counts.items()
                     if n - before[op]})


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
