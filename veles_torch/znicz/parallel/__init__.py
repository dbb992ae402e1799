"""The port's distribution layer: a mesh of ranks, sharded units and the
collectives between them.

Counterpart of ``veles/znicz_tpu/parallel/__init__.py``. The reference
lays named axes over a ``jax.sharding.Mesh`` of chips, annotates the
step's tensors and lets GSPMD insert the collectives; the port runs one
process per rank (``torch.distributed``), lays the same named axes over
the group's ranks (``numpy.array(ranks).reshape(sizes)``, one subgroup
per line of every set of axes) and writes each collective out
(``collectives.py``). Axis conventions, the reference's:

* ``data``   — batch / data parallelism (DP): each rank takes its rows of
  the one global index matrix (the same seed on every rank), a minibatch
  that does not divide is padded and masked, the evaluator normalizes by
  the global valid count, and the gradients are summed over the axis
  before every update (``TorchStep``'s flat bucket);
* ``model``  — Megatron tensor parallelism (TP) of the transformer
  units: ``heads/n`` local heads, column shards of the qkv and up
  projections, row shards of the out and down projections, the partial
  sums all-reduced in the forward and the input gradient in the
  backward; solver state sharded like its parameter;
* ``seq``    — sequence parallelism (SP): each rank holds ``S/n``
  positions of every sample and attention runs the ring
  (``parallel/ring.py``); the gradients are summed over the axis;
* ``expert`` — expert parallelism (EP) of the MoE units: each rank keeps
  E/n experts (and their solver state), the router stays whole, and the
  batch shards over the axis as over ``data``; the tokens reach their
  experts by ``"gather"`` (the ``expert`` line's token block gathered,
  the partial outputs all-reduced: ``ops/moe.py``) or ``"alltoall"`` (the
  GShard exchange: ``parallel/expert.py``);
* ``pipe``   — pipeline parallelism (PP) of the block-stack unit: each
  rank keeps L/P consecutive blocks (a stage) and runs the GPipe or 1F1B
  schedule over microbatches (``parallel/pipeline.py``); the batch is
  replicated over the axis, as the units around the stack are.

An MoE unit under any axis routes every token of the minibatch under the
global quota (``ops/moe.py``), and a dropout unit under ``data`` or
``seq`` draws the minibatch's one mask and keeps its rows or positions
(``ops/dropout.py``).

:func:`init_multihost` joins the process group and declares its
transport (``collectives.py``: ``nccl``, ``gloo-host``, ``gloo``);
:func:`spawn` runs a function in N rank processes on this host, each in
the group, and tears every rank down within a bounded time when one
fails. :func:`collective_counts` is the collectives the last train step
issued, the port's counterpart of counting opcodes in the partitioned
HLO. ``pipeline.py`` holds the stacked block's math and schedules.

A workflow whose step is its own body (the SOM, the RBM) takes DP as any
other: the step serves each rank its rows, padded and masked, and the
body's units that sum over the batch (they carry ``batch_axes``: the
Kohonen trainer, the RBM's statistics and binarization) are told the
mesh and reduce over those axes.
"""

import collections
import datetime
import itertools
import logging
import multiprocessing
import os
import queue as queue_mod
import signal
import socket
import threading
import time
import traceback

import numpy
import torch
import torch.distributed as dist

from veles_torch.znicz.parallel import collectives

logger = logging.getLogger(__name__)

#: the axes the reference names, in the order _setup_parallel lays them
AXES = ("data", "seq", "model", "expert", "pipe")

#: seconds a collective may wait on a peer before the group fails it
DEFAULT_TIMEOUT_S = 600.0

#: a rank's exit code after a preemption (``launcher.EXIT_PREEMPTED``)
EXIT_PREEMPTED = 75


class Preempted(RuntimeError):
    """Every rank of :func:`spawn` stopped on a SIGTERM (each checkpointed
    and exited with :data:`EXIT_PREEMPTED`)."""


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, transport="gloo",
                   timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group (``torch.distributed.init_process_group``):
    ``tcp://coordinator_address`` with the given world size and rank, or,
    with no address, a ``torchrun``-style environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). The
    backend follows the declared ``transport``: NCCL for ``"nccl"``, gloo
    for ``"gloo-host"`` and ``"gloo"``. -> (rank, world size)."""
    if transport not in collectives.TRANSPORTS:
        raise ValueError("transport must be one of %s, got %r"
                         % (collectives.TRANSPORTS, transport))
    kwargs = {"backend": "nccl" if transport == "nccl" else "gloo",
              "timeout": datetime.timedelta(seconds=float(timeout_s))}
    if coordinator_address is not None:
        kwargs["init_method"] = "tcp://%s" % coordinator_address
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(**kwargs)
    collectives.set_transport(transport)
    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """Named axes over the group's ranks: ``grid`` is
    ``numpy.array(ranks).reshape(sizes)``. A *line* of a set of axes is
    the ranks that differ only in those axes' coordinates, in row-major
    order of the axes; :meth:`group` is the process group of this rank's
    line (made by :func:`make_mesh`)."""

    def __init__(self, axes, ranks=None, rank=None):
        self.axis_names = tuple(axes)
        self.shape = collections.OrderedDict(
            (n, int(axes[n])) for n in self.axis_names)
        sizes = tuple(self.shape.values())
        n = int(numpy.prod(sizes, dtype=numpy.int64))
        if ranks is None:
            ranks = range(n)
        self.grid = numpy.asarray(list(ranks), dtype=numpy.int64).reshape(
            sizes)
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        self.rank = int(rank)
        self.coords = self.coords_of(self.rank)
        #: {axes tuple: (process group, size)} of this rank's lines
        self._groups = {}
        #: a gloo group over every rank of the mesh for host tensors,
        #: whatever the transport (made by :meth:`make_groups`)
        self.host_group = None

    def _axes(self, axes):
        """``axes`` (a name or names) in the mesh's order, absent names
        dropped."""
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def coords_of(self, rank):
        """{axis: coordinate} of ``rank``."""
        where = numpy.argwhere(self.grid == rank)
        if not len(where):
            raise ValueError("rank %d is not in the mesh %s"
                             % (rank, dict(self.shape)))
        return {a: int(c) for a, c in zip(self.axis_names, where[0])}

    def axis_size(self, axes):
        """The ranks of one line of ``axes`` (1 for absent axes)."""
        return int(numpy.prod([self.shape[a] for a in self._axes(axes)],
                              dtype=numpy.int64))

    def index(self, axes, rank=None):
        """``rank``'s (this rank's) place in its line of ``axes``: the
        row-major index of its coordinates over those axes."""
        coords = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def line(self, axes, rank=None):
        """The global ranks of ``rank``'s (this rank's) line of ``axes``,
        in row-major order of the axes."""
        coords = self.coords if rank is None else self.coords_of(rank)
        axes = self._axes(axes)
        sel = tuple(slice(None) if a in axes else coords[a]
                    for a in self.axis_names)
        return [int(r) for r in self.grid[sel].reshape(-1)]

    def lines(self, axes):
        """Every line of ``axes``, in a fixed order (the same on every
        rank)."""
        axes = self._axes(axes)
        others = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                          for a in others)):
            at = dict(zip(others, fixed))
            sel = tuple(slice(None) if a in axes else at[a]
                        for a in self.axis_names)
            out.append([int(r) for r in self.grid[sel].reshape(-1)])
        return out

    def group(self, axes):
        """(process group, size) of this rank's line of ``axes``; size 1
        needs no group (None)."""
        axes = self._axes(axes)
        size = self.axis_size(axes)
        if size == 1:
            return None, 1
        try:
            return self._groups[axes], size
        except KeyError:
            raise RuntimeError("mesh %s has no process group for axes %s "
                               "(made by make_mesh)"
                               % (dict(self.shape), axes))

    def make_groups(self):
        """One process group per line of every set of axes, and the host
        group, made in the same order on every rank (``new_group`` is
        collective)."""
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.axis_size(axes) == 1:
                    continue
                for ranks in self.lines(axes):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g
        if self.grid.size > 1:
            self.host_group = dist.new_group(
                [int(r) for r in self.grid.reshape(-1)], backend="gloo")
        return self

    def __repr__(self):
        return "Mesh(%s)" % dict(self.shape)


def make_mesh(axes=None, ranks=None):
    """A :class:`Mesh` over the process group with its subgroups.
    ``axes``: dict name -> size (ordered); ``None`` means one ``data``
    axis over every rank. The axes' product must equal the group's size
    (one process per rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks is None:
        ranks = list(range(world))
    if axes is None:
        axes = {"data": len(ranks)}
    sizes = [int(axes[n]) for n in axes]
    n_need = int(numpy.prod(sizes, dtype=numpy.int64))
    if n_need > len(ranks):
        raise ValueError("mesh %r needs %d devices, have %d"
                         % (dict(axes), n_need, len(ranks)))
    if n_need < len(ranks):
        raise ValueError("mesh %r covers %d of the group's %d ranks: one "
                         "process per rank, so the axes must cover all"
                         % (dict(axes), n_need, len(ranks)))
    return Mesh(axes, ranks).make_groups()


#: a sharding descriptor: ``spec`` names the mesh axis of each leading
#: dim (``()``: replicated)
Sharding = collections.namedtuple("Sharding", ("mesh", "spec"))


def batch_sharding(mesh, axis="data"):
    """Dim 0 (batch) over the data axis; the rest replicated."""
    return Sharding(mesh, (axis,))


def replicated(mesh):
    return Sharding(mesh, ())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def grad_sync_bytes(params):
    """The per-step gradient all-reduce volume (the reference's 'slave
    grad-sync bandwidth' metric): bytes of every trainable parameter in
    the (nested) dict of arrays or tensors ``params``."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            arr = numpy.asarray(leaf)
            total += int(arr.size) * arr.dtype.itemsize
    return int(total)


def collective_counts(step):
    """{opcode: count} of the collectives the step's last train step
    issued (``TorchStep.collective_counts``)."""
    return dict(step.collective_counts)


def assert_collectives(step, expected):
    """Assert the last train step issued ≥1 of each expected collective
    (and return the full counts)."""
    counts = collective_counts(step)
    missing = [op for op in expected if not counts.get(op)]
    if missing:
        raise AssertionError(
            "expected collectives %s absent from the last train step "
            "(found %s) — the sharding silently degenerated to "
            "replication" % (missing, counts))
    return counts


# ---------------------------------------------------------------------------
# shards of a parameter


#: how a parameter is cut over the mesh axis ``axis``: along ``dim``, each
#: of its ``parts`` equal sections (3 for the fused q|k|v projection) cut
#: into n chunks, rank r keeping chunk r of every section. TP cuts over
#: ``model``, EP the experts over ``expert``, PP the layers over ``pipe``
ShardSpec = collections.namedtuple("ShardSpec", ("dim", "parts", "axis"),
                                   defaults=("model",))


def shard_of(full, spec, n, r):
    """Rank ``r``'s shard of the full tensor/array ``full``."""
    sections = torch.chunk(torch.as_tensor(full), spec.parts, dim=spec.dim)
    return torch.cat([s.chunk(n, dim=spec.dim)[r] for s in sections],
                     dim=spec.dim)


def unshard(shards, spec):
    """The full tensor from every rank's shard, in rank order."""
    n = len(shards)
    per = [s.chunk(spec.parts, dim=spec.dim) for s in shards]
    return torch.cat([per[r][p] for p in range(spec.parts)
                      for r in range(n)], dim=spec.dim)


# ---------------------------------------------------------------------------
# setup of a workflow


def _step_of(workflow):
    step = workflow.step
    if step is None:
        raise ValueError("workflow has no step (a master that never "
                         "computes?)")
    return step


def _attach(workflow, mesh):
    workflow.mesh = mesh
    workflow.device.mesh = mesh
    workflow.step.mesh = mesh


def _lay_out(workflow):
    """Tell the units that see the whole minibatch where this rank's
    share lies, after every setup: a unit that sums or draws over the
    batch (it has ``batch_axes``: dropout, the SOM trainer, the RBM's
    statistics and binarization) the mesh and batch axes, a dropout unit
    its seq axis too;
    an MoE unit its token axes, with the gradient axes of its experts and
    router. An MoE unit under a batch axis needs the minibatch to divide
    (a padded row would take a slot the one device never routes)."""
    from veles_torch.znicz.ops.dropout import DropoutForward
    from veles_torch.znicz.ops.moe import MoEFFN
    step, mesh = workflow.step, workflow.mesh
    for unit in list(workflow.forwards) + list(workflow.gds):
        if hasattr(unit, "batch_axes") and not isinstance(unit, MoEFFN):
            unit.mesh = mesh
            unit.batch_axes = step.batch_axes
    for i, fwd in enumerate(workflow.forwards):
        if isinstance(fwd, DropoutForward):
            fwd.seq_axis = step.seq_axis
        if not isinstance(fwd, MoEFFN):
            continue
        fwd.data_axes = tuple(a for a in step.batch_axes
                              if a != fwd.expert_axis)
        fwd.seq_axis = step.seq_axis
        fwd.model_axis = step.model_axis
        sharded = fwd.data_axes or fwd.seq_axis or fwd.expert_axis
        fwd.mesh = mesh if sharded else None
        mb = workflow.loader.max_minibatch_size
        shards = mesh.axis_size(step.batch_axes)
        if fwd.routing == "alltoall":
            shards *= mesh.axis_size(tuple(a for a in (fwd.seq_axis,
                                                       fwd.model_axis) if a))
        if mb % shards:
            raise ValueError(
                "%s: the minibatch %d does not divide into the %d token "
                "shards of the mesh %s" % (fwd.name, mb, shards,
                                           dict(mesh.shape)))
        gd = workflow.gds[i] if i < len(workflow.gds) else None
        if gd is None or fwd.expert_axis is None:
            continue
        others = tuple(a for a in mesh.axis_names if a != fwd.expert_axis)
        experts = others if fwd.routing == "alltoall" else tuple(
            a for a in step.grad_axes if a != fwd.expert_axis)
        gd.reduce_axes = {k: experts for k in EP_KEYS}
        if fwd.routing == "alltoall" \
                and set(mesh.axis_names) != set(step.grad_axes):
            gd.reduce_axes["router"] = tuple(mesh.axis_names)


def setup_data_parallel(workflow, mesh=None, axis="data", refresh=True):
    """DP over ``mesh``: the step serves each rank its rows of every
    minibatch (padded and masked when they do not divide), the evaluator
    normalizes by the global valid count, the metrics are reduced over
    the axis and the gradients summed over it before every update.
    ``refresh`` is the reference's; the port has nothing to re-place."""
    step = _step_of(workflow)
    if mesh is None:
        mesh = make_mesh()
    if step.model_axis is not None:
        raise ValueError("setup_data_parallel after setup_tensor_parallel: "
                         "call it first, as the reference's _setup_parallel "
                         "does")
    _attach(workflow, mesh)
    if axis not in step.batch_axes:
        step.batch_axes = step.batch_axes + (axis,)
    if axis not in step.grad_axes:
        step.grad_axes = step.grad_axes + (axis,)
    _lay_out(workflow)
    return mesh


def setup_sequence_parallel(workflow, mesh, axis="seq", batch_axis=None):
    """SP: every attention unit runs the ring over ``axis``
    (``parallel/ring.py``) and each rank holds ``S/n`` positions of every
    sample: the step serves its columns of the token minibatch, the
    embedding adds the positions from the rank's global offset, the LM
    evaluator normalizes by the global token count, and the gradients are
    summed over the axis. The axis size must divide the sequence
    length. ``batch_axis`` names the mesh axis the batch is sharded over
    when SP composes with DP."""
    from veles_torch.znicz.ops.attention import MultiHeadAttention
    from veles_torch.znicz.ops.embedding import EmbeddingForward
    step = _step_of(workflow)
    n = mesh.shape[axis]
    touched = 0
    s = None
    for fwd in workflow.forwards:
        if isinstance(fwd, MultiHeadAttention):
            s = fwd.input_shape[1]
            if s % n:
                raise ValueError(
                    "%s axis size %d does not divide sequence "
                    "length %d" % (axis, n, s))
            fwd.seq_mesh = mesh
            fwd.seq_axis = axis
            fwd.seq_batch_axis = batch_axis
            touched += 1
    if not touched:
        raise ValueError("no attention units to sequence-parallelize")
    for fwd in workflow.forwards:
        if isinstance(fwd, EmbeddingForward):
            fwd.shard_positions(mesh.index(axis) * (s // n), s // n)
    if hasattr(workflow.evaluator, "seq_shards"):
        workflow.evaluator.seq_shards = n
    _attach(workflow, mesh)
    step.seq_axis = axis
    if axis not in step.grad_axes:
        step.grad_axes = step.grad_axes + (axis,)
    _lay_out(workflow)
    return mesh


#: the TP shards of each unit's parameters (the GD unit's ``vel_``,
#: ``acc_`` and ``sq_`` state shards like its parameter)
_QKV_COL, _COL, _VEC_QKV, _VEC, _ROW = (
    ShardSpec(1, 3), ShardSpec(1, 1), ShardSpec(0, 3), ShardSpec(0, 1),
    ShardSpec(0, 1))
TP_SPECS = {
    "attention": {"weights": _QKV_COL, "bias": _VEC_QKV,
                  "weights_out": _ROW},
    "ffn": {"weights": _COL, "bias": _VEC, "weights2": _ROW},
}


def setup_tensor_parallel(workflow, mesh, axis="model", refresh=True):
    """Megatron TP of the transformer units over ``axis``: each rank keeps
    ``heads/n`` heads (its q, k and v columns of ``weights``/``bias``,
    its rows of ``weights_out``; ``bias_out`` replicated, added once) and
    ``hidden/n`` FFN units (columns of ``weights``/``bias``, rows of
    ``weights2``; ``bias2`` replicated). The row-sharded products'
    partial sums are all-reduced over the axis in the forward, the input
    gradient in the backward; solver state shards like its parameter. An
    attention unit whose heads the axis does not divide, or that the
    ring owns, stays whole, as an FFN whose hidden width it does not
    divide."""
    from veles_torch.znicz.ops.attention import (
        MultiHeadAttention, TransformerFFN)
    step = _step_of(workflow)
    n = mesh.shape[axis]
    r = mesh.index(axis)
    specs = {}
    touched = 0
    for i, fwd in enumerate(workflow.forwards):
        if isinstance(fwd, MultiHeadAttention):
            if (fwd.heads % n) or fwd.seq_mesh is not None:
                continue   # head split impossible / ring owns attention
            kind = "attention"
        elif isinstance(fwd, TransformerFFN):
            if fwd.hidden and fwd.hidden % n:
                continue
            kind = "ffn"
        else:
            continue
        _shard_unit(workflow, i, TP_SPECS[kind], n, r, specs)
        fwd.tp_mesh = mesh
        fwd.tp_axis = axis
        touched += 1
    if not touched:
        raise ValueError("no TP-shardable units found")
    _attach(workflow, mesh)
    workflow.shard_specs.update(specs)
    step.model_axis = axis
    _lay_out(workflow)
    return mesh


def _shard_unit(workflow, i, key_specs, n, r, specs):
    """Cut each parameter of forward ``i`` that ``key_specs`` ({key:
    ShardSpec}) names, and its GD unit's ``vel_``/``acc_``/``sq_`` state,
    into rank ``r``'s shard of ``n``, recording the specs in ``specs``;
    the GD unit's stats then sum over the specs' axis."""
    fwd = workflow.forwards[i]
    gd = workflow.gds[i] if i < len(workflow.gds) else None
    for key, spec in key_specs.items():
        if getattr(fwd, key) is None:
            continue
        specs[(fwd.name, key)] = spec
        setattr(fwd, key, shard_of(getattr(fwd, key), spec, n, r))
        if gd is None:
            continue
        for prefix in ("vel_", "acc_", "sq_"):
            state = getattr(gd, prefix + key, None)
            if state is not None:
                specs[(gd.name, prefix + key)] = spec
                setattr(gd, prefix + key, shard_of(state, spec, n, r))
    if gd is not None:
        workflow.step.sharded_stats[gd.name] = spec.axis


#: the expert parameters EP shards (the router stays whole)
EP_KEYS = ("weights", "bias", "weights2", "bias2")


def setup_expert_parallel(workflow, mesh, axis="expert", refresh=True,
                          routing="gather"):
    """EP of the MoE units over ``axis``: the leading (expert) dim of every
    expert parameter and of its ``vel_``/``acc_``/``sq_`` state is cut
    into n shards (E/n experts a rank); the router stays whole. The batch
    shards over the axis as over ``data`` (the gradients of every other
    parameter are summed over it). ``routing``: ``"gather"`` or
    ``"alltoall"`` (module docstring); expert gradients sum over the
    token axes but ``expert``, router gradients over all of them.
    ``refresh`` is the reference's; the port has nothing to re-place."""
    from veles_torch.znicz.ops.moe import MoEFFN
    if routing not in ("gather", "alltoall"):
        raise ValueError("routing must be 'gather' or 'alltoall', "
                         "got %r" % (routing,))
    step = _step_of(workflow)
    n = mesh.shape[axis]
    r = mesh.index(axis)
    specs = {}
    touched = 0
    for i, fwd in enumerate(workflow.forwards):
        if not isinstance(fwd, MoEFFN):
            continue
        if fwd.experts % n:
            raise ValueError(
                "%s: %s axis size %d does not divide expert count %d"
                % (fwd.name, axis, n, fwd.experts))
        _shard_unit(workflow, i,
                    dict.fromkeys(EP_KEYS, ShardSpec(0, 1, axis)), n, r,
                    specs)
        fwd.expert_axis = axis
        fwd.routing = routing
        touched += 1
    if not touched:
        raise ValueError("no MoE units to expert-parallelize")
    _attach(workflow, mesh)
    workflow.shard_specs.update(specs)
    if axis not in step.batch_axes:
        step.batch_axes = step.batch_axes + (axis,)
    if axis not in step.grad_axes:
        step.grad_axes = step.grad_axes + (axis,)
    _lay_out(workflow)
    return mesh


def setup_pipeline_parallel(workflow, mesh, axis="pipe", microbatches=4,
                            batch_axis=None, refresh=True,
                            schedule="gpipe"):
    """PP of the block-stack units over ``axis``: the stacked layer dim of
    every parameter and of its solver state is cut into n stages of L/n
    consecutive blocks, and the unit runs ``schedule`` over
    ``microbatches`` microbatches (``parallel/pipeline.py``):
    ``"gpipe"`` or ``"1f1b"``, whose train step folds the loss in (one
    pipelined forward) when every unit between the stack and the
    evaluator speaks the loss-tail protocol and the evaluator has
    ``mb_loss_grad``, and else forwards twice. ``batch_axis`` names the
    axis the batch shards over when PP composes with DP; the
    microbatches must divide the per-shard minibatch. The stage
    gradients are summed over the batch axis alone."""
    from veles_torch.znicz.ops.transformer_stack import (
        TransformerBlockStack)
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError("schedule must be 'gpipe' or '1f1b', got %r"
                         % (schedule,))
    step = _step_of(workflow)
    n = mesh.shape[axis]
    r = mesh.index(axis)
    dp = mesh.shape[batch_axis] if batch_axis else 1
    specs = {}
    touched = 0
    for i, fwd in enumerate(workflow.forwards):
        if not isinstance(fwd, TransformerBlockStack):
            continue
        if fwd.layers % n:
            raise ValueError(
                "%s: %s axis size %d does not divide layer count %d"
                % (fwd.name, axis, n, fwd.layers))
        per = -(-workflow.loader.max_minibatch_size // dp)
        if per % microbatches:
            raise ValueError(
                "%s: %d microbatches do not divide the per-shard "
                "minibatch %d" % (fwd.name, microbatches, per))
        fwd.pipe_mesh = mesh
        fwd.pipe_axis = axis
        fwd.pipe_microbatches = int(microbatches)
        fwd.pipe_schedule = schedule
        fwd.pipe_tail = None
        if schedule == "1f1b":
            tail = list(workflow.forwards[i + 1:])
            ev = workflow.evaluator
            if callable(getattr(ev, "mb_loss_grad", None)) and all(
                    callable(getattr(u, "tail_fwd", None))
                    and callable(getattr(u, "tail_bwd", None))
                    for u in tail):
                fwd.pipe_tail = {"units": tail, "evaluator": ev,
                                 "step": step}
            else:
                logger.warning(
                    "%s: 1F1B loss tail %s -> %s is not foldable; the "
                    "train step will pay a second (un-stashed) forward "
                    "pass", fwd.name, [type(u).__name__ for u in tail],
                    type(ev).__name__)
        _shard_unit(workflow, i,
                    dict.fromkeys(fwd.PARAMS, ShardSpec(0, 1, axis)), n, r,
                    specs)
        touched += 1
    if not touched:
        raise ValueError("no block-stack units to pipeline")
    _attach(workflow, mesh)
    workflow.shard_specs.update(specs)
    # a collective of the whole pipe line first: NCCL leaves undefined a
    # group whose first call is a batch of point-to-point ops that some
    # of its ranks do not join (a tick where a stage has no hop)
    collectives.all_reduce(torch.zeros(1, device=workflow.device.device),
                           mesh, axis)
    return mesh


# ---------------------------------------------------------------------------
# a slave of several ranks


def _broadcast_object(obj, mesh, device):
    """``obj`` (rank 0's; pickled) on every rank of the mesh: two counted
    broadcasts, its length and its bytes."""
    import pickle
    data = pickle.dumps(obj) if mesh.rank == 0 else b""
    size = collectives.broadcast(torch.tensor(
        [len(data)], dtype=torch.int64, device=device), mesh,
        mesh.axis_names)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if mesh.rank == 0:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    out = collectives.broadcast(buf, mesh, mesh.axis_names)
    return pickle.loads(out.cpu().numpy().tobytes())


def relay_job(workflow, payload):
    """Rank 0 of a slave of several ranks hands the job ``payload`` it
    pulled from the master (None: the loop ended) to the other ranks."""
    _broadcast_object(payload, workflow.mesh, workflow.device.device)


def follow_jobs(workflow):
    """The loop of a slave's rank other than 0: apply each job rank 0
    relays (the loader's minibatch, the master's weights, each rank
    keeping its shard) and run it on this rank's share
    (``TorchStep.run_job``: the gradients summed and the update's shards
    gathered with rank 0's), until rank 0 relays None. -> the jobs
    run."""
    from veles_torch.distributable import DistributionRegistry
    registry = DistributionRegistry(workflow)
    jobs = 0
    while True:
        payload = _broadcast_object(None, workflow.mesh,
                                    workflow.device.device)
        if payload is None:
            return jobs
        registry.apply_job(payload)
        workflow.step.run_job()
        jobs += 1


# ---------------------------------------------------------------------------
# rank processes on this host


def declared_transport(device, transport, local_ranks):
    """The declared transport of ``local_ranks`` ranks on this host
    (``collectives.py``): ``gloo`` on the CPU; on the card ``transport``,
    ``nccl`` by default (one card per rank) or ``gloo-host`` (ranks
    sharing a card). Raises ValueError when it cannot be honoured: a
    transport is never swapped for another."""
    import torch
    if str(device).startswith("cpu"):
        if transport not in (None, "gloo"):
            raise ValueError("--transport %s moves card tensors; -d cpu "
                             "ranks take gloo" % transport)
        return "gloo"
    transport = transport or "nccl"
    if transport not in ("nccl", "gloo-host"):
        raise ValueError("the card's transports are nccl and gloo-host, "
                         "not %r" % (transport,))
    if not torch.cuda.is_available():
        raise ValueError("the ranks run on the card and torch sees no CUDA "
                         "device; ask for the CPU (-d cpu) for gloo ranks "
                         "of the host")
    cards = torch.cuda.device_count()
    if transport == "nccl" and cards < local_ranks:
        raise ValueError(
            "--transport nccl needs one card per rank: %d ranks, %d "
            "card(s); --transport gloo-host lets the ranks share a card "
            "(the collectives then copy through the host)"
            % (local_ranks, cards))
    return transport


def free_port():
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, args, results):
    # a torchrun-style environment of one rank on this host
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    try:
        out = fn(*args)
    except SystemExit as exc:
        if exc.code == EXIT_PREEMPTED:
            results.put((rank, "preempted", None))
            results.close()
            results.join_thread()
            os._exit(EXIT_PREEMPTED)
        if exc.code in (0, None):
            out = None
        else:
            _report_and_exit(results, rank, exc.code)
    except Exception:          # the parent reports it and tears down
        _report_and_exit(results, rank, 1)
    results.put((rank, "ok", out))


def _report_and_exit(results, rank, code):
    results.put((rank, "error", "rank %d: %s" % (rank,
                                                 traceback.format_exc())))
    results.close()
    results.join_thread()      # the report is out before the process ends
    os._exit(code if isinstance(code, int) and code else 1)


def spawn(fn, world, args=(), timeout_s=None, grace_s=10.0):
    """Run ``fn(*args)`` in ``world`` processes of the ``spawn`` context,
    each with a ``torchrun``-style environment on a free localhost port
    (``fn`` joins the group, e.g. by :func:`init_multihost`); -> the
    return values by rank. When a rank fails (or ``timeout_s`` passes)
    the others are terminated, then killed after ``grace_s``, and this
    raises RuntimeError with the failing rank's error text. A SIGTERM to
    this process (on the main thread) is forwarded to every rank, which
    stops, checkpoints and exits with :data:`EXIT_PREEMPTED`; when every
    rank has, this raises :class:`Preempted`."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=False,
                         args=(fn, r, world, port, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    done, error = {}, None
    preempted = set()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    previous = None

    def forward_sigterm(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGTERM, forward_sigterm)
    try:
        while len(done) < world and error is None:
            try:
                rank, status, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    error = "ranks timed out after %.0f s" % timeout_s
                    break
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if not dead:
                    continue
                try:   # its report may still be on the way
                    rank, status, payload = results.get(timeout=2.0)
                except queue_mod.Empty:
                    error = "rank %d exited with code %s" % dead[0]
                    break
            if status == "ok":
                done[rank] = payload
            elif status == "preempted":
                done[rank] = None
                preempted.add(rank)
            else:
                error = payload
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if error is not None or len(done) < world:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            stop = time.monotonic() + grace_s
            for p in procs:
                p.join(max(0.0, stop - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
        else:
            for p in procs:
                p.join(grace_s)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
    if error is not None:
        raise RuntimeError(error)
    if preempted:
        raise Preempted("ranks %s preempted" % sorted(preempted))
    return [done[r] for r in range(world)]
