"""TorchStep — runs the training cycle of a workflow on its device.

Counterpart of ``StepCompiler``/``build_epoch_scan``
(``veles/accelerated_units.py``) and ``XLAStep``
(``veles/znicz_tpu/xla_step.py``). A train step is forward -> evaluator
-> reversed GD chain with its updates; an eval step is forward ->
evaluator. An epoch walks the loader's class schedule in serving order
(valid before train): the dataset stays on the device and every
minibatch is gathered there by index; each class's per-minibatch
metrics stay on the device until the class ends and come to the host in
one copy, which is then handed to the decision minibatch by minibatch.
Each gathered minibatch goes through the loader's ``batch_transform``
(the reference's ``xla_batch_transform``: AlexNet's crop, mirror and
normalize) on the device; the forwards run in train mode (``.train()``)
in a train step and in eval mode in an eval step, which dropout and
stochastic pooling read. The evaluator's target is the loader array it
names (``TARGET``: ``"labels"``, or an MSE evaluator's ``"targets"``),
gathered by the same indices; targets that are the data tensor itself
(an autoencoder's) are the gathered data, not a second gather.

The model-health plane (``model_health.py``): on every
``stats_interval``-th train step, counted by the GD units' ``iteration``
before the step (``t % stats_interval == 0``, as the reference's traced
cadence; the step keeps a host mirror of it, so deciding costs no
device read), each GD unit with parameters hands its tensors to
``nn_units.layer_stats``; the step's (units, 4) vectors go into the
class's device buffer beside the metrics and reach the host in the same
one copy. Before the decision sees the class, each due step's vectors go
to the monitor's ``observe_stats`` in step order, layers sorted by name
(the reference's output order), with ``step_index`` the minibatches
served through the class (the reference publishes a fused dispatch's
stats with its step counter after the dispatch). A step that is not due
computes nothing; :meth:`TorchStep.set_stats_enabled` (False) removes
the work entirely. ``after_minibatch(cls, indices, valid, row)`` runs
after the decision accounted each minibatch (the ImageSaver).

After each class reaches the decision, ``run_epoch`` calls its
``after_class`` hook (the workflow's snapshotter and rollback). Before
every minibatch it reads ``stop_requested``: a stopped epoch ends there,
and the class in flight never reaches the decision. On a mesh of more
than one rank the ranks agree first (:meth:`TorchStep.stop_agreed`), so
every rank stops before the same minibatch: each rank's flags
(``stop_requested``, and ``preempt_requested`` for a SIGTERM) are host
state, summed by one 2-element all-reduce of host tensors over the
mesh's gloo group before the minibatch (outside the train step's
collective count), so reading them waits for no work on the card; a
rank that learns of a preemption from the others takes it as its own.
With ``take_entry`` set (a snapshotter or rollback is linked) the train
class starts by keeping ``entry``, the workflow's clone of params,
solver state and generator states: the state the epoch's validation
metric was measured on, and what a checkpoint holds while the train
class is in flight.

A workflow whose updates are not a GD chain (the Kohonen map, the RBM's
contrastive divergence) hands the step its own ``body(data, target,
valid, train)``, which returns the (4,) metrics row of one minibatch; the
step then runs that body in place of forward -> evaluator -> GD chain and
keeps everything else: the class schedule, the device-resident index
matrix, the class's one metrics copy, the decision feed and the hooks. Its
evaluator, when it has one, names the target (``TARGET``); without one the
body gets no target. Only :class:`GradientDescentBase` units give stat
rows, as only the reference's ``GradientDescentBase.update_weights``
exports layer stats.

Each class of an epoch is one dispatch, the counterpart of the
reference's fused dispatch: its wall time up to the class's one metrics
copy (the sync point, so device execution is in it) is one observation
of ``veles_torch_dispatch_seconds{kind, warm}`` and, while the tracer is
active, one ``torch.dispatch.<kind>`` span (``telemetry.py``); ``kind``
is the class (``train``, ``valid``, ``test``), ``warm`` is 0 for the
first dispatch of a class at its minibatch count in this process's
step. No device synchronization is added for either.

Each class dispatch is also accounted in the perf ledger (``perf.py``):
the first minibatch of each (class, minibatch count, stats-due)
signature runs under the ledger's cost counter (a due train step and a
plain one cost differently), computing exactly what an uncounted one
does, and the class's cost (each minibatch's signature cost, summed) goes
to ``perf.ledger.record_dispatch`` with the class's wall time, its valid
samples and, for a token loader (2-D integer data), samples × S tokens:
the ``veles_step_*{kind}`` families. :attr:`TorchStep.costs` keeps the
signatures' costs.

A loader that ``supports_streaming`` (``veles_torch/loader/stream.py``,
the reference's ``XLAStep`` stream mode) holds no device-resident data:
each class of the epoch plan is split into windows of
:meth:`TorchStep.window_minibatches` minibatches, a two-thread staging
pool materializes them on the host (``loader.materialize_window``) two
windows ahead, :class:`WindowUploader` ships each one up (pinned memory,
its own copy stream, the compute stream waiting on the copy's event) and
every minibatch is a slice of the device window, through
``batch_transform`` and the same train and eval steps; the class keeps
its one metrics copy. The time the compute loop waits on staged windows
goes to :attr:`TorchStep.stream_wait_seconds`. The cost counter sees
what the resident path's does past the gather: the slice (a free view),
``batch_transform`` and the step; the staging and the upload are not
counted as the step's work. A stopped epoch cancels the staged windows.

A slave of the master/slave mode (``client.py``) runs one minibatch
job at a time through :meth:`TorchStep.run_job`, the counterpart of the
reference's per-step mode: the job the master served
(``loader.job``: the class, the index list padded and masked as the
class schedule pads it, the valid rows) is gathered on the device (a
streaming loader materializes and uploads the one minibatch), run as a
train or eval step, and its metrics row, the due step's layer stats and
every wire parameter of the GD units come to the host in ONE packed
copy; each GD unit keeps its slice as ``wire_host`` for
``generate_data_for_master``. The master's weights reach the device
tensors in place (``GradientDescentBase.apply_data_from_master``), so no
re-upload step is needed. The bias gradient runs as on the standalone
path: one launch per GD unit with a bias in a train job. A slave of
several ranks (``parallel.relay_job``) runs each job on every rank: each
takes its rows of the job, padded and masked as a class minibatch is,
and a sharded parameter reaches the host as its full tensor, gathered
over its shard axis.

On a mesh (``veles_torch/znicz/parallel``: ``setup_data_parallel``,
``setup_sequence_parallel``, ``setup_tensor_parallel``,
``setup_expert_parallel``, ``setup_pipeline_parallel``) every rank runs
this step on its share, the same seed on every rank:

* each rank takes its rows of the one global index matrix: the
  minibatch's columns padded (repeating the last index) to a multiple of
  the batch axes' size, rank ``r`` taking the ``r``-th run of them, its
  valid count clipped; the evaluator normalizes by the minibatch's
  global valid count. Under sequence parallelism each rank also takes
  its ``S/n`` columns of the token data and labels;
* the GD units' updates are deferred while the chain runs, then every
  gradient of the step goes into ONE flat f32 bucket per set of axes it
  sums over, all-reduced (sum), and the updates run on the sums in the
  chain's order. Most gradients sum over the step's ``grad_axes`` (the
  data, seq and expert axes); an expert shard's sum over the token axes
  but ``expert``, the all-to-all router's over every axis (a GD unit's
  ``reduce_axes``). One all-reduce a train step per set, however many
  GD units: the choice of one bucket over one call per unit, whose calls
  would be as many as the units with parameters. Replicated parameters
  under TP take the same sum; their gradients are equal on the ``model``
  axis, as a pipeline stage's are on ``pipe`` (the units around the
  stack run on every stage; the stack's stage gradients are its own);
* the layer stats read the summed gradients, so every rank's stats are
  equal; the sharded units' squared norms are summed over their shard
  axis (``model``, ``expert``, ``pipe``: one small all-reduce an axis a
  due step);
* the class's metrics are gathered over the batch and seq axes at the
  class's end (one all-gather): losses and error counts summed, the
  worst row's loss maxed and its index made global (the first rank's on
  a tie); a confusion matrix's counts of the class are summed.

:attr:`TorchStep.collective_counts` holds the collectives the last train
step issued (``parallel.collective_counts``),
:attr:`TorchStep.collective_bytes` their bytes.

Eager PyTorch: each operation is its own launch (no CUDA graph yet).
"""

import collections
import concurrent.futures
import time

import numpy
import torch

from veles_torch import model_health, perf, telemetry
from veles_torch.loader.base import CLASS_TRAIN, CLASS_VALID
from veles_torch.znicz.nn_units import (
    GradientDescentBase, RoutingGradientBase, flush_deferred, layer_stats)
from veles_torch.znicz.ops.evaluator import METRICS
from veles_torch.znicz.parallel import collectives


#: the dispatch kind of each loader class
_KINDS = ("test", "valid", "train")


def _record_dispatch(kind, warm, start, dt, **args):
    """One class dispatch: its wall time up to the metrics copy (the
    sync point) by kind and warmth, and its span while the tracer is
    active."""
    telemetry.histogram(
        "veles_torch_dispatch_seconds",
        "Wall time of one class dispatch incl. its metrics copy (warm=\"0\" "
        "is the first at its minibatch count)",
        ("kind", "warm")).labels(kind, "1" if warm else "0").observe(dt)
    if telemetry.tracer.active:
        telemetry.tracer.add_complete(
            "torch.dispatch.%s" % kind, start, dt, warm=bool(warm), **args)


class TorchStep:
    """Runs the forward/evaluator/GD units of one workflow."""

    def __init__(self, loader, forwards, evaluator, gds, decision, device,
                 body=None):
        self.loader = loader
        self.forwards = list(forwards)
        self.evaluator = evaluator
        self.gds = list(gds)
        self.decision = decision
        self.device = device
        #: the workflow's own step body, or None for the GD chain
        self.body = body
        #: train and evaluation minibatches run so far
        self.train_steps = 0
        self.eval_steps = 0
        #: host seconds of each finished epoch (metric fetches included)
        self.epoch_seconds = []
        #: (class, minibatches) dispatched before: the warm ones
        self._seen_dispatch = set()
        #: read before every minibatch; True ends the epoch there
        self.stop_requested = False
        #: the stop is a preemption (SIGTERM): the launcher checkpoints
        #: and exits with its preemption code
        self.preempt_requested = False
        #: on a mesh, the (stop, preempt) flag all-reduces taken (one a
        #: minibatch) and their host seconds
        self.stop_flag_reduces = 0
        self.stop_flag_seconds = 0.0
        #: a callable -> the epoch-entry copy, or None to keep none
        self.take_entry = None
        #: the copy ``take_entry`` made as the current train class began
        self.entry = None
        #: the train class is running (not yet accounted)
        self.in_train = False
        #: layer stats for the model-health plane, every
        #: ``stats_interval``-th train step
        self.collect_model_stats = True
        self.stats_interval = 8
        #: the GD units that update parameters (the stat rows)
        self.stat_units = [gd for gd in self.gds
                           if isinstance(gd, GradientDescentBase)
                           and not isinstance(gd, RoutingGradientBase)]
        #: host mirror of the GD units' ``iteration``
        self.iteration = 0
        #: the stat rows' layer names, and the last due step's (units, 4)
        #: vectors on the device
        self.stat_names = None
        self.last_stats = None
        #: called with (cls, indices, valid, metrics row) after the
        #: decision accounted each minibatch
        self.after_minibatch = None
        #: {(class, minibatches, stats due): StepCost of one minibatch}
        self.costs = {}
        #: {kind: [wall seconds, dispatches]} of the classes run so far
        self.dispatch_seconds = {}
        #: the stream path (a loader that ``supports_streaming``): bytes
        #: of sample data in one window and its minibatch cap
        self.max_window_bytes = 96 << 20
        self.max_window_minibatches = 64
        #: {kind: [seconds the class waited on staged windows, one per
        #: class dispatch]}: near 0 when the card sets the pace, the
        #: class's time when the host's decode does
        self.stream_wait_seconds = {}
        #: minibatches per window of the last streamed epoch
        self.last_window_minibatches = None
        #: the stream path's uploader (its ``bytes`` went up) and
        #: staging pool, made on the first streamed epoch
        self.uploader = None
        self._stage_pool = None
        #: the mesh (``veles_torch/znicz/parallel``) and the axes this step
        #: shards: the batch (data, expert), the sequence, the gradient
        #: sums, TP
        self.mesh = None
        self.batch_axes = ()
        self.seq_axis = None
        self.grad_axes = ()
        self.model_axis = None
        #: {GD unit: the mesh axis its weights and bias are sharded over}
        #: (TP's ``model``, EP's ``expert``, PP's ``pipe``): their stats
        #: sum over it
        self.sharded_stats = {}
        #: {opcode: calls} and {opcode: bytes} of the last train step's
        #: collectives
        self.collective_counts = {}
        self.collective_bytes = {}
        #: (target, valid) of the train step in flight: the folded 1F1B
        #: schedule's loss tail reads it in the forward
        self.fold_target = None

    def set_stats_enabled(self, enabled):
        """Turn the layer stats on or off (off: no stat work at all)."""
        self.collect_model_stats = bool(enabled)

    def sync_iteration(self):
        """Set the host mirror of ``iteration`` from the GD units (after
        their state was loaded: one device read)."""
        for gd in self.stat_units:
            if gd.iteration is not None:
                self.iteration = int(gd.iteration)
                return

    def stats_due(self, t=None):
        """Whether the train step at ``iteration`` ``t`` (the next one by
        default) takes layer stats."""
        t = self.iteration if t is None else t
        return bool(self.collect_model_stats and self.stat_units) \
            and t % max(1, int(self.stats_interval)) == 0

    def _forward(self, data, train):
        """-> the input of every forward, and the last output; the
        forwards in train mode (``.train()``) or eval mode."""
        for f in self.forwards:
            if f.training != train:
                f.train(train)
        inputs = []
        x = data
        for f in self.forwards:
            inputs.append(x)
            x = f(x)
        return inputs, x

    def seq_shard(self, t):
        """This rank's ``S/n`` columns of a (B, S, ...) minibatch tensor
        under sequence parallelism, else ``t``."""
        if self.seq_axis is None or t is None:
            return t
        n = self.mesh.shape[self.seq_axis]
        s = t.shape[1] // n
        lo = self.mesh.index(self.seq_axis) * s
        return t[:, lo:lo + s]

    def gather(self, full, idx, train):
        """(data as the forwards take it, the evaluator's target) of the
        rows ``idx`` (a device index vector) of the loader's
        ``device_full_arrays`` ``full``."""
        rows = torch.index_select(full["data"], 0, idx)
        key = getattr(self.evaluator, "TARGET", None)
        target = None if key is None else full[key]
        if target is full["data"]:
            target = rows
        elif target is not None:
            target = torch.index_select(target, 0, idx)
        rows, target = self.seq_shard(rows), self.seq_shard(target)
        return self.loader.batch_transform(rows, train), target

    def _evaluate(self, last, target, valid):
        """The evaluator on ``valid``: a row count, or on a mesh (this
        rank's count, the minibatch's)."""
        total = None
        if isinstance(valid, tuple):
            valid, total = valid
        return self.evaluator.run(last, target, valid,
                                  self.device.act_dtype, total=total)

    def eval_minibatch(self, data, target, valid):
        """Forward + evaluator (or the body); -> the (4,) metrics
        tensor."""
        if self.body is not None:
            metrics = self.body(data, target, valid, False)
        else:
            _, last = self._forward(data, False)
            _, metrics = self._evaluate(last, target, valid)
        self.eval_steps += 1
        return metrics

    def train_minibatch(self, data, target, valid):
        """One train step with its updates; -> the (4,) metrics tensor."""
        if self.body is not None:
            if self.mesh is None:
                metrics = self.body(data, target, valid, True)
            else:
                with collectives.step_window(self.collective_counts,
                                             self.collective_bytes):
                    metrics = self.body(data, target, valid, True)
            self.train_steps += 1
            return metrics
        if self.mesh is None:
            return self.train_backward(*self._forward(data, True), target,
                                       valid)
        self.fold_target = (target, valid)
        try:
            with collectives.step_window(self.collective_counts,
                                         self.collective_bytes):
                return self.train_backward(*self._forward(data, True),
                                           target, valid)
        finally:
            self.fold_target = None

    def train_backward(self, inputs, last, target, valid):
        """The evaluator and the reversed GD chain with its updates, after
        a train-mode :meth:`_forward` that gave ``inputs`` and ``last``;
        -> the (4,) metrics tensor. On a mesh with gradient axes the
        updates wait for the step's one flat gradient all-reduce."""
        sink = [] if self.stats_due() else None
        self.last_stats = None
        deferred = [] if self.mesh is not None and self.grad_axes else None
        for gd in self.stat_units:
            gd.stats_sink = sink
        for gd in self.gds:
            gd.deferred = deferred
        err, metrics = self._evaluate(last, target, valid)
        outputs = inputs[1:] + [last]
        try:
            for i in reversed(range(len(self.gds))):
                err = self.gds[i].run(inputs[i], outputs[i], err)
            if deferred is not None:
                flush_deferred(deferred, lambda flat, axes: (
                    collectives.all_reduce(
                        flat, self.mesh,
                        self.grad_axes if axes is None else axes)))
        finally:
            for gd in self.stat_units:
                gd.stats_sink = None
            for gd in self.gds:
                gd.deferred = None
        self.iteration += 1
        self.train_steps += 1
        if sink is not None:
            sink.sort(key=lambda entry: entry[0])
            names = [name for name, _ in sink]
            if self.stat_names is not None and names != self.stat_names:
                raise RuntimeError("layer stats of %s, expected %s"
                                   % (names, self.stat_names))
            self.stat_names = names
            self.last_stats = layer_stats(sink, self._shard_sum(names))
        return metrics

    def stop_agreed(self):
        """Whether the epoch stops before the next minibatch: this
        process's ``stop_requested``, or on a mesh whether any rank's is
        set (every rank gets the same answer). A preemption on any rank
        sets ``preempt_requested`` on every rank."""
        mesh = self.mesh
        if mesh is None or mesh.axis_size(mesh.axis_names) == 1:
            return self.stop_requested
        t0 = time.perf_counter()
        flags = collectives.all_reduce_host(torch.tensor(
            [float(self.stop_requested), float(self.preempt_requested)]),
            mesh)
        self.stop_flag_reduces += 1
        self.stop_flag_seconds += time.perf_counter() - t0
        stop, preempt = (bool(v > 0) for v in flags.tolist())
        if preempt:
            self.preempt_requested = True
        if stop:
            self.stop_requested = True
        return stop

    def _shard_sum(self, names):
        """On a sharded mesh, the layer stats' reduction of the sharded
        units' (4, units) squared norms and counts over each unit's shard
        axis (one small all-reduce per axis a due step); else None."""
        axes = {}
        for i, n in enumerate(names):
            if n in self.sharded_stats:
                axes.setdefault(self.sharded_stats[n], []).append(i)
        if not axes:
            return None
        mesh = self.mesh

        def reduce(per):
            out = per
            for axis, cols in axes.items():
                mask = torch.zeros(per.shape[1], dtype=per.dtype,
                                   device=per.device)
                mask[cols] = 1.0
                out = out * (1.0 - mask) + collectives.all_reduce(
                    per * mask, mesh, axis)
            return out
        return reduce

    def shard_plan(self, plan):
        """The epoch plan as this rank serves it: [(cls, its idx_mat, its
        valids, the minibatches' idx_mat padded to the ranks, their
        valids, rows a rank), ...]; the plan as it is off a batch-sharded
        mesh."""
        nb = self.mesh.axis_size(self.batch_axes) if self.mesh else 1
        if nb == 1:
            return [(cls, idx_mat, valids, idx_mat, valids,
                     idx_mat.shape[1]) for cls, idx_mat, valids in plan]
        r = self.mesh.index(self.batch_axes)
        out = []
        for cls, idx_mat, valids in plan:
            mb = idx_mat.shape[1]
            per = -(-mb // nb)
            if per * nb > mb:
                idx_mat = numpy.concatenate(
                    [idx_mat, numpy.repeat(idx_mat[:, -1:], per * nb - mb,
                                           axis=1)], axis=1)
            local = numpy.ascontiguousarray(idx_mat[:, r * per:(r + 1) * per])
            mine = numpy.clip(valids - r * per, 0, per).astype(valids.dtype)
            out.append((cls, local, mine, idx_mat, valids, per))
        return out

    def _metric_axes(self):
        axes = self.batch_axes + ((self.seq_axis,) if self.seq_axis else ())
        if self.mesh is None or self.mesh.axis_size(axes) == 1:
            return None
        return axes

    def reduce_metrics(self, metrics, per):
        """The class's (n, 4) device metrics of every rank of this rank's
        batch and seq line -> the minibatches' (n, 4) host metrics:
        ``loss`` and ``n_err`` summed, ``max_err`` maxed with the global
        index of its row (the first rank's on a tie)."""
        axes = self._metric_axes()
        parts = collectives.all_gather(metrics.contiguous(), self.mesh, axes)
        every = torch.stack(parts).cpu().numpy()       # (ranks, n, 4)
        offsets = numpy.array(
            [self.mesh.index(self.batch_axes, rank=r) * per
             for r in self.mesh.line(axes)], numpy.float32)
        n = every.shape[1]
        best = numpy.argmax(every[:, :, 2], axis=0)
        out = numpy.empty((n, every.shape[2]), numpy.float32)
        out[:, 0] = every[:, :, 0].sum(axis=0)
        out[:, 1] = every[:, :, 1].sum(axis=0)
        out[:, 2] = every[best, numpy.arange(n), 2]
        out[:, 3] = every[best, numpy.arange(n), 3] + offsets[best]
        return out

    def _confusion_sum(self, before):
        """Sum the class's confusion counts over the batch line."""
        ev = self.evaluator
        cm = getattr(ev, "confusion_matrix", None)
        if cm is None or self._metric_axes() is None:
            return
        base = before if before is not None else torch.zeros_like(cm)
        ev.confusion_matrix = base + collectives.all_reduce(
            cm - base, self.mesh, self._metric_axes())

    def _minibatch(self, step, fetch, train, valid, metrics, i, stats, j):
        """One minibatch (``fetch()`` -> its data and target) into row
        ``i`` of the class's metrics and, when it took layer stats, row
        ``j`` of its stats; -> the next stats row."""
        metrics[i] = step(*fetch(), valid)
        if train and self.last_stats is not None:
            stats[j] = self.last_stats
            self.last_stats = None
            return j + 1
        return j

    def _publish_stats(self, rows, step_index):
        """Hand each due step's host (units, 4) stat rows to the
        model-health monitor, in step order."""
        monitor = model_health.get_model_monitor()
        for row in rows:
            monitor.observe_stats(dict(zip(self.stat_names, row)),
                                  step_index=step_index)

    def window_minibatches(self):
        """Minibatches per streamed window: bounded by
        ``max_window_bytes`` over the bytes of one minibatch of the
        loader's ``sample_spec`` (what the host ships) and by
        ``max_window_minibatches``."""
        loader = self.loader
        per_mb = loader.max_minibatch_size * sum(
            int(numpy.prod(shape, dtype=numpy.int64)) * numpy.dtype(dt).itemsize
            for shape, dt in loader.sample_spec().values())
        w = max(1, int(self.max_window_bytes // max(per_mb, 1)))
        return min(w, int(self.max_window_minibatches))

    def window_batch(self, window, k, train):
        """(data as the forwards take it, the evaluator's target) of
        minibatch ``k`` of the uploaded ``window``."""
        rows = window["data"][k]
        key = getattr(self.evaluator, "TARGET", None)
        if key is None:
            target = None
        elif key == "targets" and self.loader.targets_are_data:
            target = rows
        else:
            target = window[key][k]
        rows, target = self.seq_shard(rows), self.seq_shard(target)
        return self.loader.batch_transform(rows, train), target

    def close(self):
        """Shut the stream path's staging pool down (a later streamed
        epoch makes a new one)."""
        pool, self._stage_pool = self._stage_pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def run_epoch(self, after_class=None):
        """Serve every class of the loader's current epoch and feed the
        decision, calling ``after_class(cls)`` after each; -> False when
        ``stop_requested`` ended the epoch first."""
        t0 = time.perf_counter()
        loader = self.loader
        dev = self.device.device
        plan = self.shard_plan(loader.epoch_plan())
        feed = _StreamFeed(self, [p[:3] for p in plan]) \
            if loader.supports_streaming \
            else _ResidentFeed(self, loader.device_full_arrays(dev))
        try:
            if not self._run_classes(plan, feed, after_class):
                return False
        finally:
            feed.close()
        self.epoch_seconds.append(time.perf_counter() - t0)
        return True

    def _run_classes(self, plan, feed, after_class):
        loader = self.loader
        dev = self.device.device
        has_valid = loader.class_lengths[CLASS_VALID] > 0
        for ci, (cls, idx_mat, mine, whole, valids, per) in enumerate(plan):
            train = cls == CLASS_TRAIN
            t_class = time.perf_counter()
            if train:
                self.entry = self.take_entry() if self.take_entry else None
                self.in_train = True
            step = self.train_minibatch if train else self.eval_minibatch
            feed.start_class(ci, idx_mat)
            sharded = self._metric_axes() is not None
            if sharded:
                pairs = torch.as_tensor(numpy.stack([mine, valids], 1)).to(dev)
                valid_dev = [(v[0], v[1]) for v in pairs]
                cm = getattr(self.evaluator, "confusion_matrix", None)
                cm_before = None if cm is None else cm.clone()
            else:
                valid_dev = torch.as_tensor(valids).to(dev)
            n = len(idx_mat)
            # the class's one device buffer: its metrics, then the stat
            # rows of its due train steps
            due = sum(self.stats_due(self.iteration + i)
                      for i in range(n)) if train else 0
            width = len(METRICS)
            stat_width = len(model_health.STAT_FIELDS)
            buf = torch.empty(
                n * width + due * len(self.stat_units) * stat_width,
                dtype=torch.float32, device=dev)
            metrics = buf[:n * width].view(n, width)
            stats = buf[n * width:].view(due, len(self.stat_units),
                                         stat_width)
            j = 0
            cost = perf.StepCost()
            for i in range(n):
                if self.stop_agreed():
                    return False
                sig = (cls, n, train and self.stats_due())
                j, one = perf.ledger.cost(
                    (id(self),) + sig, self._minibatch,
                    (step, feed.minibatch(i, train), train, valid_dev[i],
                     metrics, i, stats, j), owner=self)
                self.costs[sig] = one
                cost = cost + one
            if sharded:
                host = numpy.concatenate([
                    self.reduce_metrics(metrics, per).reshape(-1),
                    buf[n * width:].cpu().numpy()])
                self._confusion_sum(cm_before)
            else:
                host = buf.cpu().numpy()
            dt = time.perf_counter() - t_class
            warm = (cls, n) in self._seen_dispatch
            self._seen_dispatch.add((cls, n))
            kind = _KINDS[cls]
            _record_dispatch(kind, warm, t_class, dt, minibatches=n,
                             **feed.dispatch_args())
            total = self.dispatch_seconds.setdefault(kind, [0.0, 0])
            total[0] += dt
            total[1] += 1
            feed.end_class(kind)
            samples = int(valids.sum())
            perf.ledger.record_dispatch(kind, cost, dt, samples=samples,
                                        tokens=feed.tokens(samples),
                                        device=dev)
            if due:
                self._publish_stats(
                    host[n * width:].reshape(stats.shape),
                    self.decision.minibatch_count + n)
            host = host[:n * width].reshape(n, width)
            last_cls = ci == len(plan) - 1
            for i, row in enumerate(host):
                last = i == len(host) - 1
                self.decision.on_minibatch(
                    cls, int(valids[i]), row, last_minibatch=last,
                    epoch_ended=last and last_cls, has_valid=has_valid)
                if self.after_minibatch is not None:
                    self.after_minibatch(cls, whole[i], int(valids[i]),
                                         row)
            self.in_train = False
            if after_class is not None:
                after_class(cls)
        return True


    def run_job(self):
        """Run the loader's served job (``loader.job``) once: a train
        step with its updates, or an eval step; -> its host (4,)
        metrics row. The metrics, the layer stats of a due train step
        and the GD units' wire parameters come to the host in one
        packed copy; each GD unit gets its parameters as
        ``wire_host``, and due stats go to the model-health monitor."""
        loader = self.loader
        if loader.job is None:
            raise RuntimeError("%s: no job served (apply_data_from_master "
                               "first)" % loader.name)
        cls, idx, valid = loader.job
        loader.job = None
        train = cls == CLASS_TRAIN
        dev = self.device.device
        t0 = time.perf_counter()
        nb = self.mesh.axis_size(self.batch_axes) if self.mesh else 1
        if nb > 1:
            # this rank's rows of the job, padded and masked as a class
            # minibatch is (``shard_plan``)
            idx = numpy.asarray(idx)
            per = -(-len(idx) // nb)
            idx = numpy.concatenate([idx, numpy.repeat(
                idx[-1:], per * nb - len(idx))])
            r = self.mesh.index(self.batch_axes)
            idx = idx[r * per:(r + 1) * per]
            counts = [int(numpy.clip(valid - r * per, 0, per)), int(valid)]
        else:
            counts = [int(valid)]
        # the indices and the valid counts go up in one copy
        up = torch.as_tensor(numpy.append(
            idx, numpy.asarray(counts, numpy.int32))).to(dev)
        valid_dev = (up[-2], up[-1]) if nb > 1 else up[-1]
        rows = up[:-len(counts)]
        if loader.supports_streaming:
            if self.uploader is None:
                self.uploader = WindowUploader(dev)
            window = self.uploader.upload(
                loader.materialize_window(cls, numpy.asarray(idx)[None]))
            data, target = self.window_batch(window, 0, train)
        else:
            data, target = self.gather(loader.device_full_arrays(dev),
                                       rows.to(torch.int64), train)
        step = self.train_minibatch if train else self.eval_minibatch
        metrics = step(data, target, valid_dev)
        stats, self.last_stats = self.last_stats if train else None, None
        parts = [metrics.reshape(-1).to(torch.float32)]
        if stats is not None:
            parts.append(stats.reshape(-1))
        wire = [(gd, [(name, _full_wire(gd, name, t))
                      for name, t in gd._wire_params()])
                for gd in self.gds if hasattr(gd, "_wire_params")]
        parts += [t.detach().reshape(-1).to(torch.float32)
                  for _, params in wire for _, t in params]
        host = torch.cat(parts).cpu().numpy()
        row, pos = host[:len(METRICS)], len(METRICS)
        if stats is not None:
            n = stats.numel()
            self._publish_stats([host[pos:pos + n].reshape(stats.shape)],
                                self.train_steps)
            pos += n
        for gd, params in wire:
            values = {}
            for name, t in params:
                n = t.numel()
                values[name] = host[pos:pos + n].reshape(tuple(t.shape))
                pos += n
            gd.wire_host = values
        kind = "job." + _KINDS[cls]
        total = self.dispatch_seconds.setdefault(kind, [0.0, 0])
        total[0] += time.perf_counter() - t0
        total[1] += 1
        return row


def _full_wire(gd, name, t):
    """A GD unit's wire parameter as the master takes it: on a sharded
    mesh the full tensor, gathered over its shard axis (a collective every
    rank of a slave runs), else ``t``."""
    wf = getattr(gd, "workflow", None)
    if wf is None or not getattr(wf, "shard_specs", None):
        return t
    return wf._full_tensor(gd.forward.name, name, t)


def _tokens(samples, shape, floating):
    """Tokens of ``samples`` samples of a token loader (1-D integer
    samples: S tokens each), else None."""
    if len(shape) == 1 and not floating:
        return samples * int(shape[0])
    return None


class _ResidentFeed:
    """The minibatches of a device-resident dataset: each a gather by
    index from ``loader.device_full_arrays``."""

    def __init__(self, step, full):
        self.step = step
        self.full = full
        self.idx = None

    def start_class(self, ci, idx_mat):
        self.idx = torch.as_tensor(idx_mat, dtype=torch.int64).to(
            self.step.device.device)

    def minibatch(self, i, train):
        """-> the costed fetch of minibatch ``i``."""
        full, idx = self.full, self.idx[i]
        return lambda: self.step.gather(full, idx, train)

    def dispatch_args(self):
        return {}

    def end_class(self, kind):
        pass

    def tokens(self, samples):
        data = self.full["data"]
        return _tokens(samples, data.shape[1:],
                       data.dtype.is_floating_point)

    def close(self):
        pass


class _StreamFeed:
    """The minibatches of a streaming loader: the epoch's classes split
    into windows of ``step.window_minibatches()``; a two-thread staging
    pool runs ``loader.materialize_window`` two windows ahead (no more:
    staged windows never pile up in host memory), each window is uploaded
    by the step's :class:`WindowUploader` when its first minibatch comes,
    and a minibatch is a slice of it. The wait for a staged window is
    timed into ``step.stream_wait_seconds``; the staging and the upload
    run outside the minibatch's costed call."""

    DEPTH = 2

    def __init__(self, step, plan):
        self.step = step
        self.loader = step.loader
        self.w = step.window_minibatches()
        step.last_window_minibatches = self.w
        if step._stage_pool is None:
            step._stage_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="stream-stage")
        if step.uploader is None:
            step.uploader = WindowUploader(step.device.device)
        self.spans = [(cls, idx_mat[lo:lo + self.w])
                      for cls, idx_mat, _ in plan
                      for lo in range(0, len(idx_mat), self.w)]
        self.staged = collections.deque()
        self.next_span = 0
        for _ in range(self.DEPTH):
            self._stage()
        self.window = None
        self.windows = 0
        self.wait = 0.0
        shape, dtype = self.loader.sample_spec()["data"]
        self.data_spec = (tuple(shape), numpy.dtype(dtype).kind == "f")

    def _stage(self):
        if self.next_span < len(self.spans):
            cls, rows = self.spans[self.next_span]
            self.staged.append(self.step._stage_pool.submit(
                self.loader.materialize_window, cls, rows))
            self.next_span += 1

    def start_class(self, ci, idx_mat):
        self.windows = 0
        self.wait = 0.0

    def minibatch(self, i, train):
        k = i % self.w
        if k == 0:
            t = time.perf_counter()
            host = self.staged.popleft().result()
            self.wait += time.perf_counter() - t
            self._stage()
            self.window = self.step.uploader.upload(host)
            self.windows += 1
        window = self.window
        return lambda: self.step.window_batch(window, k, train)

    def dispatch_args(self):
        return {"windows": self.windows}

    def end_class(self, kind):
        self.step.stream_wait_seconds.setdefault(kind, []).append(self.wait)

    def tokens(self, samples):
        return _tokens(samples, *self.data_spec)

    def close(self):
        self.window = None
        for future in self.staged:
            future.cancel()
        self.staged.clear()


class WindowUploader:
    """Host windows (dict name -> numpy array) -> tensors on ``device``;
    integer ``labels`` become int64 there.

    On a card each array is copied into a pinned host buffer, one of
    ``DEPTH`` per name used in turn, and uploaded with ``non_blocking`` on
    the uploader's own copy stream; the compute stream waits on the
    copy's event, and a pinned buffer is refilled only after the event of
    its previous copy has completed. The device tensors are allocated on
    the copy stream and recorded on the compute stream
    (``record_stream``), so their memory is not handed out again while
    the compute stream still reads it. On the CPU the host arrays are
    used as they are. ``bytes`` counts what went up."""

    #: pinned buffers per name, used in turn
    DEPTH = 2

    def __init__(self, device):
        self.device = torch.device(device)
        self.bytes = 0
        self.uploads = 0
        self._cuda = self.device.type == "cuda"
        self._stream = None
        #: per slot: ({name: pinned uint8 buffer}, the event of its copy)
        self._slots = [({}, None) for _ in range(self.DEPTH)]

    def upload(self, window):
        out = {}
        if not self._cuda:
            for name, arr in window.items():
                out[name] = torch.from_numpy(numpy.ascontiguousarray(arr))
        else:
            out = self._upload_cuda(window)
        self.uploads += 1
        self.bytes += sum(int(arr.nbytes) for arr in window.values())
        if "labels" in out and not out["labels"].dtype.is_floating_point:
            out["labels"] = out["labels"].to(torch.int64)
        return out

    def _upload_cuda(self, window):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        compute = torch.cuda.current_stream(self.device)
        slot = self.uploads % self.DEPTH
        buffers, event = self._slots[slot]
        if event is not None:
            event.synchronize()      # this slot's last copy has finished
        out = {}
        with torch.cuda.stream(self._stream):
            for name, arr in window.items():
                src = torch.from_numpy(numpy.ascontiguousarray(arr))
                nbytes = src.numel() * src.element_size()
                buf = buffers.get(name)
                if buf is None or buf.numel() < nbytes:
                    buf = buffers[name] = torch.empty(
                        nbytes, dtype=torch.uint8, pin_memory=True)
                pinned = buf[:nbytes].view(src.dtype).view(src.shape)
                pinned.copy_(src)
                dev = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
                dev.copy_(pinned, non_blocking=True)
                dev.record_stream(compute)
                out[name] = dev
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[slot] = (buffers, event)
        compute.wait_event(event)
        return out
