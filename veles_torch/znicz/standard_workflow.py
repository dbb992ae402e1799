"""StandardWorkflow of the PyTorch port — the config-driven builder.

Counterpart of ``veles/znicz_tpu/standard_workflow.py``: from the same
``layers`` list

    layers=[{"type": "all2all_tanh", "->": {...forward kwargs...},
             "<-": {...gd kwargs...}}, ...]

(ints are shorthand: hidden all2all_tanh, final softmax) it builds the
loader, the forwards through the port's registry (an int
``output_shape_source`` names an earlier forward by index, as the
reference's autoencoders pin a deconv or depooling to the mirrored
unit's input shape), the evaluator (an ``evaluator_factory(workflow)``
when given, else the softmax evaluator for a softmax-terminated stack
and ``EvaluatorMSE`` against the loader's targets for any other), the
decision (``DecisionGD`` after the softmax evaluator, ``DecisionMSE``
after any other, as the reference picks) and the reversed GD chain, with
the reference's unit names (class name, made unique with ``_2``,
``_3``...). :meth:`StandardWorkflow.link_zero_filler` pins weight
entries of a forward at zero; :meth:`StandardWorkflow.link_lr_adjuster`
gives every GD unit an lr schedule (a layer's ``"<-"`` kwargs carry the
solver options and per-layer policies, as in the reference);
:meth:`StandardWorkflow.link_image_saver` dumps each minibatch's worst
sample (``image_saver.py``).
:meth:`StandardWorkflow.link_plotters` attaches the reference's
standard plot set (``nn_plotting_units.py``).
``initialize`` places everything on a device; ``run`` trains epoch by
epoch until the decision completes, or until :meth:`NNWorkflow.stop`
ends it before the next minibatch.

:class:`NNWorkflow` (the reference's ``NNWorkflow``) is the part that
does not depend on a GD chain: the slots (loader, forwards, evaluator,
decision, gds), the run loop, the units after the decision and the
state below. A workflow whose updates are not a GD chain (the Kohonen map,
the RBM) subclasses it, builds its units, initializes them in
:meth:`NNWorkflow.initialize_units` and gives the step its own
``step_body`` (``step.py``). Its plotters (``plotters``) run once an
epoch after the decision ended it, each publishing to the workflow's
``graphics`` server when the launcher attached one, else rendering into
its own ``out_dir``.

State (the reference's ``NNWorkflow``): :meth:`NNWorkflow.
checkpoint_state` is the checkpoint tree in the reference's sections
(``params`` and ``state`` by unit name, ``decision``, ``loader``,
``rollback``, ``lr_scales`` of the units that have one, ``meta`` and
``units``: the device generators' states; the params of every forward
and the state of every gds unit that has some, the reference's
``_stateful_units``) and :meth:`NNWorkflow.restore_state` loads one
into an initialized workflow; :meth:`NNWorkflow.stash_state` /
:meth:`NNWorkflow.restore_stash` are NNRollback's copies on the
device. After each class of an epoch reaches the decision the workflow
runs, in the reference's order, the end of the epoch's bookkeeping (the
loader moves to the next epoch), at an epoch's end the plotters and the
shell (:meth:`NNWorkflow.link_shell`, ``interaction.py``), then the
snapshotter (:meth:`NNWorkflow.link_snapshotter`, or
``snapshotter_config``) and the rollback (:meth:`NNWorkflow.link_rollback`).

On a mesh under tensor parallelism (``shard_specs`` set by
``parallel.setup_tensor_parallel``) :meth:`NNWorkflow.checkpoint_state`
gathers every sharded parameter and solver tensor over the ``model`` axis
into the full one (a collective: every rank calls it, rank 0 writes), so
a checkpoint holds the reference's full tensors, and
:meth:`NNWorkflow.import_tree` cuts a full tensor into this rank's shard.

A checkpoint holds the state at the last class boundary the run passed:
before the train class and while it runs, the epoch's entry (the copy
the step keeps once a snapshotter or rollback is linked; the state the
validation metric was measured on), with the loader's generator state
from before the epoch's shuffle; after the train class, the live state,
with the loader already in the next epoch. A resume restarts the
loader's epoch and redraws its shuffle from that state, so a resumed run
equals the uninterrupted one.
"""

import contextlib
import logging
import sys

import numpy
import torch

from veles_torch.backends import get_device
from veles_torch.config import _resolve
from veles_torch.export_inference import export_inference
from veles_torch.interaction import Shell
from veles_torch.snapshotter import (
    CorruptCheckpointError, Snapshotter, host_copy)
from veles_torch.znicz.decision import DecisionGD, DecisionMSE
from veles_torch.znicz.image_saver import ImageSaver
from veles_torch.znicz.lr_adjust import make_policy
from veles_torch.znicz.nn_plotting_units import (
    AccumulatingPlotter, ConfusionMatrixPlotter, Weights2D)
from veles_torch.znicz.nn_rollback import NNRollback
from veles_torch.znicz.nn_units import forward_by_name, gradient_unit_for
from veles_torch.znicz.ops.all2all import All2AllSoftmax
from veles_torch.znicz.ops.cutter import ZeroFiller
from veles_torch.znicz.ops.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_torch.znicz.step import TorchStep

logger = logging.getLogger("veles_torch.workflow")


def normalize_layers(layers):
    """Expand int shorthands into layer dicts."""
    out = []
    for i, layer in enumerate(layers):
        if isinstance(layer, int):
            kind = "softmax" if i == len(layers) - 1 else "all2all_tanh"
            layer = {"type": kind, "->": {"output_sample_shape": layer}}
        out.append(dict(layer))
    return out


def _resolved(spec):
    """A layer spec's kwargs with Tune leaves collapsed to their defaults:
    the layer dicts are plain python, so Config's read-time resolution
    does not reach them (the genetic optimizer writes concrete values
    into the same leaves)."""
    return {k: _resolve(v) for k, v in spec.items()}


def _held_arrays(values, depth=2):
    """The torch tensors and numpy arrays among ``values`` and inside
    their dicts, lists and tuples, ``depth`` levels down."""
    for v in values:
        if isinstance(v, (torch.Tensor, numpy.ndarray)):
            yield v
        elif depth and isinstance(v, dict):
            yield from _held_arrays(v.values(), depth - 1)
        elif depth and isinstance(v, (list, tuple)):
            yield from _held_arrays(v, depth - 1)


class NNWorkflow:
    """The slots, run loop and state of a workflow of the port."""

    #: ``body(data, target, valid, train) -> (4,) metrics`` of a workflow
    #: whose updates are not a GD chain, or None (``step.py``)
    step_body = None

    def __init__(self, name):
        self.name = name
        self._names = set()
        self.loader = None
        self.forwards = []
        self.evaluator = None
        self.decision = None
        self.gds = []
        self.device = None
        self.step = None
        self.snapshotter = None
        self.rollback = None
        self.image_saver = None
        #: the interactive shell run at each epoch's end (link_shell)
        self.shell = None
        #: plot units run once an epoch after the decision
        self.plotters = []
        #: the GraphicsServer plots publish to (set by the launcher)
        self.graphics = None
        #: runs started (the reference's ``meta.run_number``)
        self.run_number = 0
        #: the master/slave mode's wire codecs (``compression.py``): a
        #: slave's negotiated encoder (set by ``SlaveClient``), a
        #: master's encoder per slave (set by ``MasterServer``)
        self.grad_codec = None
        self.grad_codec_by_slave = None
        #: the mesh of a parallel run (``veles_torch/znicz/parallel``), and
        #: {(unit, key): ShardSpec} of the tensors TP cut into shards
        self.mesh = None
        self.shard_specs = {}

    def _unique(self, name):
        base, i = name, 2
        while name in self._names:
            name = "%s_%d" % (base, i)
            i += 1
        self._names.add(name)
        return name

    def __iter__(self):
        """The units in the reference's order: loader, forwards,
        evaluator, decision, GD chain (what the wire's
        ``DistributionRegistry`` walks)."""
        units = [self.loader, *self.forwards, self.evaluator,
                 self.decision, *self.gds]
        return iter([u for u in units if u is not None])

    def initialize(self, device="cuda", with_step=True):
        """Load the data, draw the first epoch's shuffle, create the
        parameters on ``device`` (``"cuda"``, ``"cpu"`` or a
        TorchDevice). ``with_step=False`` (a master of the master/slave
        mode, which never computes) builds no step."""
        self.device = get_device(device)
        self.loader.initialize()
        self.initialize_units()
        for gd in self.gds:
            gd.workflow = self
        if not with_step:
            return self
        self.step = TorchStep(self.loader, self.forwards, self.evaluator,
                              self.gds, self.decision, self.device,
                              body=self.step_body)
        if self.snapshotter is not None:
            self.snapshotter.initialize()
        self._keep_entry()
        self._hook_image_saver()
        return self

    def initialize_units(self):
        """Create the units' parameters and state on ``self.device`` (the
        loader is initialized)."""
        raise NotImplementedError

    def _hook_image_saver(self):
        if self.step is not None and self.image_saver is not None:
            self.step.after_minibatch = self.image_saver.on_minibatch

    def _keep_entry(self):
        """The step keeps an epoch-entry copy only for a consumer: a
        snapshotter or a rollback."""
        if self.step is not None:
            keep = self.snapshotter is not None or self.rollback is not None
            self.step.take_entry = self._copy_view if keep else None

    def link_snapshotter(self, **cfg):
        """A :class:`Snapshotter` (its prefix defaults to the workflow's
        name), run after the decision at each class boundary;
        initialized at once when the workflow already is. -> it."""
        cfg.setdefault("prefix", self.name)
        snap = Snapshotter(self, **cfg)
        snap.decision = self.decision
        self.snapshotter = snap
        if self.step is not None:
            snap.initialize()
        self._keep_entry()
        return snap

    def link_rollback(self, **cfg):
        """An :class:`NNRollback`, run after the snapshotter at each
        epoch's end. -> it."""
        self.rollback = NNRollback(self, **cfg)
        self._keep_entry()
        return self.rollback

    def link_shell(self, commands=None):
        """A :class:`Shell` (``interaction.py``) run at each epoch's end,
        after the decision and the plotters: an interactive console on a
        TTY, else ``commands`` if given. Its ``stop()`` is :meth:`stop`.
        -> it."""
        self.shell = Shell(self, commands=commands)
        return self.shell

    def run(self):
        """Train until the decision completes or :meth:`stop` is
        called."""
        self.run_number += 1
        while self.step.run_epoch(self._after_decision) \
                and not self.decision.complete:
            pass
        return self

    def _after_decision(self, cls):
        """The units after the decision, in the reference's order."""
        if self.decision.epoch_ended:
            self.loader.next_epoch()
            for plotter in self.plotters:
                plotter.run()
            if self.shell is not None:
                self.shell.run()
        if self.snapshotter is not None:
            self.snapshotter.run()
        if self.rollback is not None:
            self.rollback.run()

    def stop(self):
        """End :meth:`run` before its next minibatch (the minibatches of
        the class in flight are not accounted); a later :meth:`run` ends
        at once."""
        if self.step is not None:
            self.step.stop_requested = True

    def close(self):
        """Stop the threads the run started: the stream path's staging
        pool and the loader's (a streaming loader's decode pool and
        ingest producer). A later :meth:`run` starts them again."""
        if self.step is not None:
            self.step.close()
        if self.loader is not None:
            self.loader.stop()

    def export_inference(self, path):
        """Write the inference archive (contents.json + .npy weights) of
        this workflow's forward chain; -> the path of its contents.json.
        On a mesh every rank calls it and rank 0 alone writes (-> None on
        the others); under TP the archive holds the full tensors, gathered
        over the model axis (a collective)."""
        with self._full_forward_params():
            if self.mesh is not None and self.mesh.rank != 0:
                return None
            return export_inference(self, path)

    @contextlib.contextmanager
    def _full_forward_params(self):
        """The forwards' TP shards swapped for their full tensors for the
        block's duration (the gathers run in ``shard_specs``' order, the
        same on every rank)."""
        units = {f.name: f for f in self.forwards}
        swapped = []
        try:
            for name, key in self.shard_specs:
                unit = units.get(name)
                if unit is None:
                    continue            # a GD unit's solver state
                shard = getattr(unit, key)
                setattr(unit, key, self._full_tensor(name, key, shard))
                swapped.append((unit, key, shard))
            yield
        finally:
            for unit, key, shard in swapped:
                setattr(unit, key, shard)

    # -- introspection (the reference's Workflow) -------------------------

    def _units_after_decision(self):
        return [u for u in (*self.plotters, self.shell, self.snapshotter,
                            self.rollback) if u is not None]

    def generate_graph(self):
        """Graphviz dot of the unit graph (``--workflow-graph``), in the
        reference's form: the run loop's control points as its trivial
        units (``start_point``, ``repeater``, ``end_point``; ovals), then
        the loader, the forwards, the evaluator and the decision, the GD
        chain back to the repeater (the decision straight back when the
        workflow has no GD chain), and the units run after the decision.
        The step (``TorchStep``) runs the loader-to-GD cycle fused."""
        control = [("start_point", "StartPoint"), ("end_point", "EndPoint"),
                   ("repeater", "Repeater")]
        chain = [self.loader, *self.forwards, self.evaluator, self.decision]
        chain = [u for u in chain if u is not None]
        gds = list(reversed(self.gds))
        units = chain + gds + self._units_after_decision()
        lines = ["digraph %s {" % self.name.replace(" ", "_"),
                 "  rankdir=TB;"]
        nodes = control + [(u.name, type(u).__name__) for u in units]
        order = {name: i for i, (name, _) in enumerate(nodes)}
        for i, (name, kind) in enumerate(nodes):
            lines.append('  u%d [label="%s\\n%s" shape=%s];' % (
                i, name, kind, "oval" if i < len(control) else "box"))
        cycle = ["start_point", "repeater"] + [u.name for u in chain]
        edges = list(zip(cycle, cycle[1:]))
        back = [self.decision.name] + [u.name for u in gds] + ["repeater"]
        edges += list(zip(back, back[1:]))
        edges += [(self.decision.name, "end_point")]
        edges += [(self.decision.name, u.name)
                  for u in self._units_after_decision()]
        # by source node, as the reference walks each unit's links
        for a, b in sorted(edges, key=lambda e: order[e[0]]):
            lines.append("  u%d -> u%d;" % (order[a], order[b]))
        lines.append("}")
        return "\n".join(lines)

    def print_stats(self, stream=sys.stderr):
        """Wall-time table of the run (the reference's per-unit table):
        one row per dispatch kind of the step, the loader-to-GD cycle run
        fused (``TorchStep``), slowest first."""
        seconds = self.step.dispatch_seconds if self.step is not None \
            else {}
        rows = sorted(((t, calls, "step.%s" % kind) for kind, (t, calls)
                       in seconds.items()), reverse=True)
        total = sum(r[0] for r in rows) or 1e-12
        stream.write("%-32s %10s %8s %7s\n"
                     % ("unit", "time(s)", "calls", "share"))
        for t, calls, name in rows:
            stream.write("%-32s %10.4f %8d %6.1f%%\n"
                         % (name, t, calls, 100.0 * t / total))

    def print_unit_sizes(self, stream=sys.stderr):
        """Bytes of the tensors and host arrays each unit holds
        (``--dump-unit-sizes``), a storage shared by several tensors or
        units counted once, largest first."""
        rows = []
        seen = set()
        units = [self.loader, *self.forwards, self.evaluator, self.decision,
                 *self.gds, *self._units_after_decision()]
        for u in units:
            if u is None:
                continue
            total = 0
            for a in _held_arrays(vars(u).values()):
                if isinstance(a, torch.Tensor):
                    storage = a.untyped_storage()
                    key, nbytes = (a.device, storage.data_ptr()), \
                        storage.nbytes()
                else:
                    key, nbytes = ("host", a.__array_interface__["data"][0],
                                   a.nbytes), a.nbytes
                if nbytes and key not in seen:
                    seen.add(key)
                    total += nbytes
            if total:
                rows.append((total, u.name))
        rows.sort(reverse=True)
        stream.write("%-32s %12s\n" % ("unit", "bytes"))
        for nbytes, name in rows:
            stream.write("%-32s %12d\n" % (name, nbytes))
        stream.write("%-32s %12d\n" % ("TOTAL", sum(r[0] for r in rows)))

    # -- state exchange with the reference (see veles_torch/convert.py) --

    def units(self):
        """{name: unit} of every unit holding parameters or state."""
        return {u.name: u for u in self.forwards + self.gds}

    def export_tree(self):
        """{unit: {key: tensor}}: forwards' params (and a ZeroFiller's
        mask as ``zero_mask``) and GDs' state."""
        tree = {}
        for name, u in self.units().items():
            if u in self.forwards:
                sub = u.export_params()
                if u.zero_mask is not None:
                    sub["zero_mask"] = u.zero_mask
            else:
                sub = u.export_state()
            if sub:
                tree[name] = sub
        return tree

    # -- checkpoint / resume (the reference's NNWorkflow) ----------------

    def _generator_units(self):
        return [u for u in self.forwards if hasattr(u, "get_state")]

    def _other_state_units(self):
        """The units whose ``get_state`` rides in a checkpoint's
        ``units`` section: the device generators, the ImageSaver."""
        units = self._generator_units()
        if self.image_saver is not None:
            units.append(self.image_saver)
        return units

    def _live_view(self):
        """{params, state, units, step_index} of the live tensors."""
        return {"params": {f.name: f.export_params() for f in self.forwards},
                "state": {g.name: g.export_state() for g in self.gds},
                "units": {u.name: u.get_state()
                          for u in self._generator_units()},
                "step_index": self.step.train_steps
                if self.step is not None else 0}

    def _copy_view(self):
        """A clone of :meth:`_live_view` on the device (the step's
        epoch-entry copy, a rollback's stash)."""
        view = self._live_view()
        for section in ("params", "state"):
            view[section] = {name: {k: t.clone() for k, t in sub.items()}
                             for name, sub in view[section].items()}
        return view

    def _checkpoint_view(self):
        if self.step is None or not self.step.in_train:
            return self._live_view()
        if self.step.entry is None:
            raise RuntimeError(
                "%s: no epoch-entry copy to checkpoint while the train "
                "class runs (link the snapshotter before the epoch)"
                % self.name)
        return self.step.entry

    def checkpoint_state(self):
        """The checkpoint tree (host arrays and JSON-able values) of the
        last class boundary the run passed."""
        view = self._checkpoint_view()
        tree = {"params": {}, "state": {},
                "meta": {"workflow": self.name,
                         "run_number": self.run_number,
                         "step_index": int(view["step_index"])}}
        for section in ("params", "state"):
            for name, sub in view[section].items():
                if sub:
                    tree[section][name] = {
                        k: host_copy(self._full_tensor(name, k, t))
                        for k, t in sub.items()}
        tree["decision"] = self.decision.get_state()
        tree["loader"] = self.loader.get_state()
        if self.rollback is not None:
            tree["rollback"] = self.rollback.get_state()
        lr_scales = {gd.name: float(gd.lr_scale) for gd in self.gds
                     if hasattr(gd, "lr_scale")}
        if lr_scales:
            tree["lr_scales"] = lr_scales
        units = dict(view["units"])
        if self.image_saver is not None:
            units[self.image_saver.name] = self.image_saver.get_state()
        if units:
            tree["units"] = units
        return tree

    def _full_tensor(self, name, key, t):
        """The full tensor of a TP shard (gathered over the model axis: a
        collective), else ``t``."""
        spec = self.shard_specs.get((name, key))
        if spec is None:
            return t
        from veles_torch.znicz.parallel import collectives, unshard
        return unshard(collectives.all_gather(
            t.contiguous(), self.mesh, self.step.model_axis), spec)

    def _own_part(self, name, key, value):
        """This rank's shard of a full checkpoint value under TP, else
        the value."""
        spec = self.shard_specs.get((name, key))
        if spec is None:
            return value
        from veles_torch.znicz.parallel import shard_of
        axis = self.step.model_axis
        return shard_of(torch.as_tensor(numpy.asarray(value)), spec,
                        self.mesh.axis_size(axis), self.mesh.index(axis))

    def restore_state(self, tree):
        """Load a checkpoint tree (this package's or the reference's) into
        the initialized workflow; the loader restarts its epoch. Each unit
        of the workflow takes its own entries: a shape or key it lacks
        raises :class:`CorruptCheckpointError`; a unit name the workflow
        lacks is warned and skipped."""
        for section in ("params", "state"):
            self.import_tree(tree.get(section, {}), skip_unknown=True)
        if "decision" in tree:
            self.decision.set_state(tree["decision"])
        if "loader" in tree:
            self.loader.set_state(tree["loader"])
        if self.rollback is not None and "rollback" in tree:
            self.rollback.set_state(tree["rollback"])
        for gd in self.gds:
            if gd.name in tree.get("lr_scales", {}):
                gd.lr_scale = float(tree["lr_scales"][gd.name])
        others = {u.name: u for u in self._other_state_units()}
        for name, state in tree.get("units", {}).items():
            if name not in others:
                logger.warning("checkpoint names unknown unit %r — "
                               "skipped", name)
                continue
            others[name].set_state(state)
        if self.step is None:
            return
        self.step.train_steps = int(tree.get("meta", {}).get("step_index",
                                                             0))
        self.step.sync_iteration()
        self.step.entry, self.step.in_train = None, False

    def stash_state(self, at_valid=False):
        """A copy of every unit's params and solver state on the device;
        ``at_valid``: the epoch-entry copy, on which the epoch's
        validation metric was measured. Load it back with
        :meth:`restore_stash`."""
        if not at_valid:
            return self._copy_view()
        if self.step.entry is None:
            raise RuntimeError("%s: no epoch-entry copy (link a snapshotter "
                               "or rollback before the epoch)" % self.name)
        return self.step.entry

    def restore_stash(self, stash):
        """Load a :meth:`stash_state` copy back, COPYING it: the updates
        that follow must not write into the stash, or a second rollback
        would restore diverged values."""
        for section in ("params", "state"):
            self.import_tree(stash[section])
        if self.step is not None:
            self.step.sync_iteration()

    def import_tree(self, tree, skip_unknown=False):
        """Load a tree shaped like :meth:`export_tree` (a checkpoint's
        ``params`` or ``state`` section): every value is copied onto the
        device and dtype of the unit's tensor. A key the unit lacks or
        another shape raises :class:`CorruptCheckpointError`, and so does
        a unit name this workflow lacks, unless ``skip_unknown``: then it
        is warned and skipped (the reference's rule for a resume). Under
        TP a full value of a sharded tensor loads as this rank's shard."""
        units = self.units()
        for name, sub in tree.items():
            unit = units.get(name)
            if unit is None:
                if not skip_unknown:
                    raise CorruptCheckpointError(
                        "%s: no unit named %r" % (self.name, name))
                logger.warning("checkpoint names unknown unit %r — "
                               "skipped", name)
                continue
            for key, value in sub.items():
                old = getattr(unit, key, None)
                if isinstance(old, torch.Tensor) \
                        and tuple(old.shape) != tuple(numpy.shape(value)):
                    value = self._own_part(name, key, value)
                if not isinstance(old, torch.Tensor):
                    raise CorruptCheckpointError(
                        "checkpoint entry %s/%s: the unit has no such "
                        "tensor" % (name, key))
                if tuple(old.shape) != tuple(numpy.shape(value)):
                    raise CorruptCheckpointError(
                        "checkpoint entry %s/%s: shape %s, the unit's %s"
                        % (name, key, tuple(numpy.shape(value)),
                           tuple(old.shape)))
                setattr(unit, key, torch.as_tensor(value).to(
                    device=old.device, dtype=old.dtype, copy=True))


class StandardWorkflow(NNWorkflow):
    """loader -> forwards -> evaluator -> decision -> reversed GDs."""

    def __init__(self, layers=None, loader_factory=None,
                 decision_config=None, evaluator_factory=None,
                 name="StandardWorkflow", snapshotter_config=None):
        if loader_factory is None:
            raise ValueError("no loader_factory given")
        super().__init__(name)
        self.layers_config = normalize_layers(layers or [])
        self.loader = loader_factory(self)
        for spec in self.layers_config:
            cls = forward_by_name(spec["type"])
            kwargs = _resolved(spec.get("->", {}))
            src = kwargs.get("output_shape_source")
            if isinstance(src, int) and not isinstance(src, bool):
                kwargs["output_shape_source"] = self.forwards[src]
            fwd = cls(**kwargs)
            fwd.name = self._unique(fwd.name)
            self.forwards.append(fwd)
        if evaluator_factory is not None:
            self.evaluator = evaluator_factory(self)
        elif isinstance(self.forwards[-1], All2AllSoftmax):
            self.evaluator = EvaluatorSoftmax(name="evaluator")
        else:
            self.evaluator = EvaluatorMSE(name="evaluator")
        decision_cls = DecisionGD \
            if isinstance(self.evaluator, EvaluatorSoftmax) else DecisionMSE
        self.decision = decision_cls(name="decision",
                                     **dict(decision_config or {}))
        self.gds = [None] * len(self.forwards)
        for i in reversed(range(len(self.forwards))):
            fwd = self.forwards[i]
            gd = gradient_unit_for(type(fwd))(
                need_err_input=i > 0,
                **_resolved(self.layers_config[i].get("<-", {})))
            gd.name = self._unique(gd.name)
            self.gds[i] = gd.setup_forward(fwd)
        self.zero_fillers = []
        if snapshotter_config is not None:
            self.link_snapshotter(**snapshotter_config)

    def initialize_units(self):
        shape = (self.loader.max_minibatch_size,) \
            + self.loader.sample_shape()
        for fwd in self.forwards:
            fwd.input_shape = shape
            shape = fwd.initialize(shape, self.device)
        for gd in self.gds:
            gd.initialize()
        for zf in self.zero_fillers:
            zf.initialize()

    def link_zero_filler(self, target, mask=None, name="zerofiller"):
        """A :class:`ZeroFiller` of ``target`` (a forward unit or its
        index), initialized with the workflow (at once when the workflow
        already is); -> the ZeroFiller."""
        if isinstance(target, int):
            target = self.forwards[target]
        zf = ZeroFiller(target=target, mask=mask, name=self._unique(name))
        self.zero_fillers.append(zf)
        if self.device is not None:
            zf.initialize()
        return zf

    def link_lr_adjuster(self, lr_policy=None, bias_lr_policy=None):
        """Give every GD unit an lr schedule (objects or config dicts, see
        ``lr_adjust.py``); the bias policy defaults to ``lr_policy``.
        -> the GD units."""
        policy = make_policy(lr_policy)
        bias_policy = make_policy(bias_lr_policy) or policy
        for gd in self.gds:
            gd.lr_policy = policy
            gd.lr_policy_bias = bias_policy
        return self.gds

    def link_image_saver(self, out_dir, **cfg):
        """An :class:`ImageSaver` writing each minibatch's worst sample
        under ``out_dir``, run after the decision accounted the
        minibatch. -> it."""
        self.image_saver = ImageSaver(self, out_dir=out_dir,
                                      name="image_saver", **cfg)
        self._hook_image_saver()
        return self.image_saver

    def link_plotters(self, out_dir=None, weights=True, confusion=None):
        """The reference's standard plot set, run once an epoch after the
        decision: the metric curves (``plot_metric``), the first layer's
        weights (``plot_weights``) and, by default when the evaluator
        computes one, the confusion matrix (``plot_confusion``). Each
        publishes to ``graphics`` when the launcher attached a server,
        else renders into ``out_dir``. -> the plotters."""
        units = [AccumulatingPlotter(self, name="plot_metric",
                                     out_dir=out_dir)]
        if weights:
            units.append(Weights2D(self, name="plot_weights",
                                   out_dir=out_dir))
        if confusion is None:
            confusion = isinstance(self.evaluator, EvaluatorSoftmax) \
                and self.evaluator.compute_confusion
        if confusion:
            units.append(ConfusionMatrixPlotter(
                self, name="plot_confusion", out_dir=out_dir))
        self.plotters = units
        return units
