"""Global mutable configuration tree of the PyTorch port.

Counterpart of ``veles/config.py``, kept to what the samples read:

* a process-global tree ``root`` with attribute access;
* sub-trees auto-vivify on attribute access, so config code can write
  ``root.mnist.decision.max_epochs = 3`` directly;
* ``Config.update(dict)`` deep-merges nested dicts;
* CLI dot-path overrides (``root.a.b=3`` with python-literal values).
"""

import ast
import os
from typing import Any, Dict, Iterator, Tuple


class Config:
    """A node in the global config tree."""

    def __init__(self, path: str):
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_items", {})

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        items = object.__getattribute__(self, "_items")
        if name not in items:
            items[name] = Config("%s.%s" % (self._path, name))
        return items[name]

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
        return object.__getattribute__(self, "_items").get(name, default)

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

    def to_dict(self) -> Dict[str, Any]:
        return {key: value.to_dict() if isinstance(value, Config) else value
                for key, value in self.items()}

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
    },
    # dtype policy overrides read by backends.TorchDevice:
    # compute_dtype (matmul inputs) and amp (tensors between units)
    "engine": {"compute_dtype": None, "amp": None},
})
