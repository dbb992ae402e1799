"""StandardWorkflow of the PyTorch port — the config-driven builder.

Counterpart of ``veles/znicz_tpu/standard_workflow.py``: from the same
``layers`` list

    layers=[{"type": "all2all_tanh", "->": {...forward kwargs...},
             "<-": {...gd kwargs...}}, ...]

(ints are shorthand: hidden all2all_tanh, final softmax) it builds the
loader, the forwards through the port's registry, the evaluator, the
decision and the reversed GD chain, with the reference's unit names
(class name, made unique with ``_2``, ``_3``...). ``initialize`` places
everything on a device; ``run`` trains epoch by epoch until the decision
completes.
"""

from veles_torch.backends import get_device
from veles_torch.znicz.decision import DecisionGD
from veles_torch.znicz.nn_units import forward_by_name, gradient_unit_for
from veles_torch.znicz.ops.all2all import All2AllSoftmax
from veles_torch.znicz.ops.evaluator import EvaluatorSoftmax
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
                 decision_config=None, name="StandardWorkflow"):
        if loader_factory is None:
            raise ValueError("no loader_factory given")
        self.name = name
        self.layers_config = normalize_layers(layers or [])
        self._names = set()
        self.loader = loader_factory(self)
        self.forwards = []
        for spec in self.layers_config:
            cls = forward_by_name(spec["type"])
            fwd = cls(**dict(spec.get("->", {})))
            fwd.name = self._unique(fwd.name)
            self.forwards.append(fwd)
        if not isinstance(self.forwards[-1], All2AllSoftmax):
            raise NotImplementedError(
                "only softmax-terminated layer stacks are ported")
        self.evaluator = EvaluatorSoftmax(name="evaluator")
        self.decision = DecisionGD(name="decision",
                                   **dict(decision_config or {}))
        self.gds = [None] * len(self.forwards)
        for i in reversed(range(len(self.forwards))):
            fwd = self.forwards[i]
            gd = gradient_unit_for(type(fwd))(
                need_err_input=i > 0,
                **dict(self.layers_config[i].get("<-", {})))
            gd.name = self._unique(gd.name)
            self.gds[i] = gd.setup_forward(fwd)
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
            + self.loader.original_data.shape[1:]
        for fwd in self.forwards:
            shape = fwd.initialize(shape, self.device)
        for gd in self.gds:
            gd.initialize()
        self.step = TorchStep(self.loader, self.forwards, self.evaluator,
                              self.gds, self.decision, self.device)
        return self

    def run(self):
        """Train until the decision completes."""
        while True:
            self.step.run_epoch()
            if self.decision.complete:
                return self
            self.loader.next_epoch()

    # -- state exchange with the reference (see veles_torch/convert.py) --

    def units(self):
        """{name: unit} of every unit holding parameters or state."""
        return {u.name: u for u in self.forwards + self.gds}

    def export_tree(self):
        """{unit: {key: tensor}}: forwards' params and GDs' state."""
        tree = {}
        for name, u in self.units().items():
            sub = u.export_params() if u in self.forwards \
                else u.export_state()
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
