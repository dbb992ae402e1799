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
solver options and per-layer policies, as in the reference).
``initialize`` places everything on a device; ``run`` trains epoch by
epoch until the decision completes.
"""

from veles_torch.backends import get_device
from veles_torch.export_inference import export_inference
from veles_torch.znicz.decision import DecisionGD, DecisionMSE
from veles_torch.znicz.lr_adjust import make_policy
from veles_torch.znicz.nn_units import forward_by_name, gradient_unit_for
from veles_torch.znicz.ops.all2all import All2AllSoftmax
from veles_torch.znicz.ops.cutter import ZeroFiller
from veles_torch.znicz.ops.evaluator import EvaluatorMSE, EvaluatorSoftmax
from veles_torch.znicz.step import TorchStep


def normalize_layers(layers):
    """Expand int shorthands into layer dicts."""
    out = []
    for i, layer in enumerate(layers):
        if isinstance(layer, int):
            kind = "softmax" if i == len(layers) - 1 else "all2all_tanh"
            layer = {"type": kind, "->": {"output_sample_shape": layer}}
        out.append(dict(layer))
    return out


class StandardWorkflow:
    """loader -> forwards -> evaluator -> decision -> reversed GDs."""

    def __init__(self, layers=None, loader_factory=None,
                 decision_config=None, evaluator_factory=None,
                 name="StandardWorkflow"):
        if loader_factory is None:
            raise ValueError("no loader_factory given")
        self.name = name
        self.layers_config = normalize_layers(layers or [])
        self._names = set()
        self.loader = loader_factory(self)
        self.forwards = []
        for spec in self.layers_config:
            cls = forward_by_name(spec["type"])
            kwargs = dict(spec.get("->", {}))
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
                **dict(self.layers_config[i].get("<-", {})))
            gd.name = self._unique(gd.name)
            self.gds[i] = gd.setup_forward(fwd)
        self.zero_fillers = []
        self.device = None
        self.step = None

    def _unique(self, name):
        base, i = name, 2
        while name in self._names:
            name = "%s_%d" % (base, i)
            i += 1
        self._names.add(name)
        return name

    def initialize(self, device="cuda"):
        """Load the data, draw the first epoch's shuffle, create the
        parameters on ``device`` (``"cuda"``, ``"cpu"`` or a
        TorchDevice)."""
        self.device = get_device(device)
        self.loader.initialize()
        shape = (self.loader.max_minibatch_size,) \
            + self.loader.sample_shape()
        for fwd in self.forwards:
            fwd.input_shape = shape
            shape = fwd.initialize(shape, self.device)
        for gd in self.gds:
            gd.initialize()
        for zf in self.zero_fillers:
            zf.initialize()
        self.step = TorchStep(self.loader, self.forwards, self.evaluator,
                              self.gds, self.decision, self.device)
        return self

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

    def run(self):
        """Train until the decision completes."""
        while True:
            self.step.run_epoch()
            if self.decision.complete:
                return self
            self.loader.next_epoch()

    def export_inference(self, path):
        """Write the inference archive (contents.json + .npy weights) of
        this workflow's forward chain; -> the path of its contents.json."""
        return export_inference(self, path)

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

    def import_tree(self, tree):
        """Load a tree shaped like :meth:`export_tree` (tensors are copied
        to this workflow's device; shapes and keys must match)."""
        units = self.units()
        for name, sub in tree.items():
            unit = units[name]
            for key, value in sub.items():
                old = getattr(unit, key, None)
                if old is None:
                    raise KeyError("%s has no %r" % (name, key))
                if tuple(old.shape) != tuple(value.shape):
                    raise ValueError("%s.%s: shape %s != %s" % (
                        name, key, tuple(value.shape), tuple(old.shape)))
                setattr(unit, key, value.to(device=old.device,
                                            dtype=old.dtype, copy=True))
