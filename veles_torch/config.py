"""Global mutable configuration tree of the PyTorch port.

Counterpart of ``veles/config.py``, kept to what the samples read:

* a process-global tree ``root`` with attribute access;
* sub-trees auto-vivify on attribute access, so config code can write
  ``root.mnist.decision.max_epochs = 3`` directly;
* ``Config.update(dict)`` deep-merges nested dicts;
* CLI dot-path overrides (``root.a.b=3`` with python-literal values);
* ``Tune(default, min, max)`` leaves marking a value searchable by the
  genetic optimizer (``genetics.py``): a read resolves one to its
  ``default``, :meth:`Config.raw` returns the leaf itself, and
  :meth:`Config.tunables` lists them by dotted path.
"""

import ast
import os
from typing import Any, Dict, Iterator, Tuple


class Tune:
    """A config leaf marked as tunable by the genetic optimizer: reads
    through :class:`Config` give its ``default``; ``min_value`` and
    ``max_value`` bound the search. It is discrete when the default and
    both ends are ints (not bools), unless ``discrete`` says otherwise."""

    __slots__ = ("default", "min_value", "max_value", "discrete")

    def __init__(self, default, min_value, max_value, discrete=None):
        self.default = default
        self.min_value = min_value
        self.max_value = max_value
        if discrete is None:
            discrete = all(
                isinstance(v, int) and not isinstance(v, bool)
                for v in (default, min_value, max_value))
        self.discrete = discrete

    def clip(self, value):
        """``value`` clipped into [min_value, max_value], rounded to an
        int when discrete."""
        value = max(self.min_value, min(self.max_value, value))
        if self.discrete:
            value = int(round(value))
        return value

    def __repr__(self):
        return ("Tune(%r, %r, %r)"
                % (self.default, self.min_value, self.max_value))


def _resolve(value):
    return value.default if isinstance(value, Tune) else value


class Config:
    """A node in the global config tree. Attribute reads of missing names
    make child nodes; writes store leaves as given (a :class:`Tune`
    included), and reads resolve a :class:`Tune` to its default."""

    def __init__(self, path: str):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_items", {})

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        items = object.__getattribute__(self, "_items")
        if name not in items:
            items[name] = Config("%s.%s" % (self._path, name))
        return _resolve(items[name])

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if isinstance(value, dict):
            node = Config("%s.%s" % (self._path, name))
            node.update(value)
            value = node
        object.__getattribute__(self, "_items")[name] = value

    def __contains__(self, name: str) -> bool:
        return name in object.__getattribute__(self, "_items")

    def get(self, name: str, default: Any = None) -> Any:
        items = object.__getattribute__(self, "_items")
        return _resolve(items[name]) if name in items else default

    def raw(self, name: str) -> Any:
        """The stored leaf, a :class:`Tune` unresolved."""
        return object.__getattribute__(self, "_items")[name]

    def update(self, tree: Dict[str, Any]) -> "Config":
        """Deep-merge a nested dict into this node."""
        for key, value in tree.items():
            if isinstance(value, dict):
                child = getattr(self, key)
                if not isinstance(child, Config):
                    child = Config("%s.%s" % (self._path, key))
                    object.__getattribute__(self, "_items")[key] = child
                child.update(value)
            else:
                setattr(self, key, value)
        return self

    def apply_override(self, assignment: str) -> None:
        """Apply one ``a.b.c=value`` override (value is a python literal;
        bare words fall back to strings). The leading ``root.`` is
        optional."""
        path, sep, literal = assignment.partition("=")
        if not sep:
            raise ValueError("override must look like path=value: %r"
                             % assignment)
        parts = path.strip().split(".")
        if parts and parts[0] in ("root", self._path.split(".")[0]):
            parts = parts[1:]
        if not parts or any(not p.isidentifier() for p in parts):
            raise ValueError("bad override path in %r" % assignment)
        node = self
        for part in parts[:-1]:
            nxt = getattr(node, part)
            if not isinstance(nxt, Config):
                nxt = Config("%s.%s" % (node._path, part))
                object.__getattribute__(node, "_items")[part] = nxt
            node = nxt
        try:
            value = ast.literal_eval(literal.strip())
        except (ValueError, SyntaxError):
            value = literal.strip()
        setattr(node, parts[-1], value)

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(object.__getattribute__(self, "_items").items())

    def flatten(self, prefix: str = "") -> Dict[str, Any]:
        """{dotted path: stored leaf} of every leaf under this node."""
        out = {}
        for key, value in self.items():
            full = "%s.%s" % (prefix, key) if prefix else key
            if isinstance(value, Config):
                out.update(value.flatten(full))
            else:
                out[full] = value
        return out

    def tunables(self, prefix: str = "") -> Dict[str, Tune]:
        """All Tune leaves under this node, keyed by dotted path."""
        return {k: v for k, v in self.flatten(prefix).items()
                if isinstance(v, Tune)}

    def to_dict(self) -> Dict[str, Any]:
        return {key: value.to_dict() if isinstance(value, Config)
                else _resolve(value) for key, value in self.items()}

    def __repr__(self):
        return "<Config %s: %d item(s)>" % (
            self._path, len(object.__getattribute__(self, "_items")))


#: The process-global config tree every sample and override mutates.
root = Config("root")

root.common.update({
    "dirs": {
        # real idx files are looked up here before the synthetic
        # stand-in is generated (models/datasets.py)
        "datasets": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "datasets"),
        # a snapshotter linked without a directory writes here
        "snapshots": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "snapshots"),
        # the forge client's package store when none is given
        "forge": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "forge"),
    },
    # dtype policy overrides read by backends.TorchDevice:
    # compute_dtype (matmul inputs) and amp (tensors between units)
    "engine": {"compute_dtype": None, "amp": None},
})
