"""Inference-archive export of the PyTorch port.

Counterpart of ``veles/export_inference.py``, writing the same archive
(the input of ``libveles/``, ``veles/serving`` and
``veles_torch/serving``): a directory holding

    contents.json      — format 1, the workflow's name, the input sample
                         shape and the ordered unit list, each unit with
                         its type, name, config and parameter file names
    <unit>_<param>.npy — float32 parameter arrays (C order)

Unit ``type`` strings are the port's layer-registry names (``MAPPING``),
which equal the reference's; a unit whose type the engines do not know
is refused. Parameters are read through ``export_params``, which returns
the live (device) tensors, and copied to host f32 arrays before they are
written, so an archive of the same weights is the same bytes whichever
package wrote it.
"""

import json
import os

import numpy
import torch

from veles_torch.serving.model import FORWARD_OPS
from veles_torch.znicz.ops.activation import ActivationForward
from veles_torch.znicz.ops.all2all import All2AllBase
from veles_torch.znicz.ops.attention import (
    MultiHeadAttention, TokenDenseBase, TransformerFFN)
from veles_torch.znicz.ops.conv import ConvBase
from veles_torch.znicz.ops.deconv import Deconv, Depooling
from veles_torch.znicz.ops.dropout import DropoutForward
from veles_torch.znicz.ops.embedding import (
    EmbeddingForward, sinusoidal_positions)
from veles_torch.znicz.ops.layernorm import LayerNormForward
from veles_torch.znicz.ops.normalization import LRNormalizerForward
from veles_torch.znicz.ops.moe import MoEFFN
from veles_torch.znicz.ops.pooling import PoolingBase, StochasticPooling
from veles_torch.znicz.ops.transformer_stack import TransformerBlockStack

#: the types the serving planes (``serving/model.py``) and the C++ engine
#: (libveles/src/units.cc) know; the exporter refuses any other
ENGINE_TYPES = frozenset(FORWARD_OPS)


def host_f32(t):
    """A tensor (on any device) -> a C-contiguous float32 numpy copy."""
    return numpy.ascontiguousarray(
        t.detach().to("cpu", torch.float32).numpy(), numpy.float32)


def positions_table(unit):
    """The extended sinusoidal table an embedding exports (4× its
    training length, at least 256 rows), or None without positions: a
    decoder can then grow sequences past the training length."""
    if unit.positions is None:
        return None
    n = max(4 * unit.positions.shape[0], 256)
    return sinusoidal_positions(n, unit.dim)


def unit_spec(unit):
    """-> (spec, params) of one forward unit: the spec's type, name and
    config as the archive writes them, and the ordered ``{key: tensor or
    None}`` of the parameters it references. Raises on a unit the
    engines cannot run."""
    type_name = getattr(type(unit), "MAPPING", None)
    if type_name not in ENGINE_TYPES:
        raise ValueError(
            "cannot export unit %s (%s, type %r): no C++ engine "
            "counterpart" % (unit.name, type(unit).__name__, type_name))
    spec = {"type": type_name, "name": unit.name, "config": {}}
    cfg = spec["config"]
    p = unit.export_params()
    params = {}
    if isinstance(unit, All2AllBase):
        cfg["neurons"] = int(unit.neurons)
        cfg["output_sample_shape"] = list(unit.output_sample_shape)
        spec["weights_transposed"] = bool(unit.weights_transposed)
        params = {"weights": p["weights"], "bias": p.get("bias")}
    elif isinstance(unit, ConvBase):
        cfg.update({"n_kernels": int(unit.n_kernels),
                    "kx": int(unit.kx), "ky": int(unit.ky),
                    "sliding": list(unit.sliding),
                    "padding": list(unit.padding)})
        params = {"weights": p["weights"], "bias": p.get("bias")}
    elif isinstance(unit, Deconv):
        # the resolved output geometry: output_shape_source pins it at
        # initialize, and an engine cannot derive it from the config
        cfg.update({"n_kernels": int(unit.n_kernels),
                    "kx": int(unit.kx), "ky": int(unit.ky),
                    "sliding": list(unit.sliding),
                    "padding": list(unit.padding),
                    "out_shape": [int(d) for d in unit.out_shape]})
        params = {"weights": p["weights"]}
    elif isinstance(unit, Depooling):
        cfg.update({"kx": int(unit.kx), "ky": int(unit.ky),
                    "sliding": list(unit.sliding),
                    "out_shape": [int(d) for d in unit.out_shape]})
    elif isinstance(unit, StochasticPooling):
        raise ValueError(
            "%s: stochastic pooling has no deterministic inference form "
            "in the C++ engine" % unit.name)
    elif isinstance(unit, PoolingBase):
        cfg.update({"kx": int(unit.kx), "ky": int(unit.ky),
                    "sliding": list(unit.sliding)})
    elif isinstance(unit, LRNormalizerForward):
        cfg.update({"alpha": float(unit.alpha), "beta": float(unit.beta),
                    "n": int(unit.n), "k": float(unit.k)})
    elif isinstance(unit, EmbeddingForward):
        cfg.update({"vocab_size": int(unit.vocab_size),
                    "dim": int(unit.dim)})
        params = {"weights": p["weights"], "bias": None}
        table = positions_table(unit)
        if table is not None:
            params["positions"] = torch.from_numpy(table)
    elif isinstance(unit, LayerNormForward):
        cfg["eps"] = float(unit.eps)
        params = {"weights": p["weights"], "bias": p["bias"]}
    elif isinstance(unit, MultiHeadAttention):
        cfg.update({"heads": int(unit.heads), "causal": bool(unit.causal),
                    "residual": bool(unit.residual),
                    "include_bias": bool(unit.include_bias)})
        params = {"weights": p["weights"], "bias": p.get("bias"),
                  "weights_out": p["weights_out"],
                  "bias_out": p.get("bias_out")}
    elif isinstance(unit, TransformerFFN):
        cfg.update({"hidden": int(unit.hidden),
                    "residual": bool(unit.residual)})
        params = {k: p[k] for k in ("weights", "bias", "weights2",
                                    "bias2")}
    elif isinstance(unit, MoEFFN):
        cfg.update({"experts": int(unit.experts), "hidden": int(unit.hidden),
                    "residual": bool(unit.residual),
                    "capacity_factor": float(unit.capacity_factor)})
        params = {k: p[k] for k in ("weights", "bias", "weights2", "bias2",
                                    "router")}
    elif isinstance(unit, TransformerBlockStack):
        cfg.update({"layers": int(unit.layers), "heads": int(unit.heads),
                    "hidden": int(unit.hidden), "causal": bool(unit.causal),
                    "eps": float(unit.eps)})
        params = {k: p[k] for k in unit.PARAMS}
    elif isinstance(unit, TokenDenseBase):
        cfg["output_features"] = int(unit.output_features)
        params = {"weights": p["weights"], "bias": p.get("bias")}
    elif isinstance(unit, (DropoutForward, ActivationForward)):
        pass                    # no parameters, no configuration
    else:
        raise ValueError("cannot export unit %s (%s): no C++ engine "
                         "counterpart" % (unit.name, type(unit).__name__))
    return spec, params


def _npy_name(unit, param):
    return "%s_%s.npy" % (unit.name.replace("/", "_"), param)


def _write_unit(unit, path):
    spec, params = unit_spec(unit)
    for key, t in params.items():
        if t is None:
            spec[key] = None
            continue
        fname = _npy_name(unit, key)
        numpy.save(os.path.join(path, fname), host_f32(t))
        spec[key] = fname
    return spec


def export_inference(workflow, path):
    """Write the inference archive of ``workflow``'s forward chain into
    directory ``path`` (created if missing); -> the path of its
    ``contents.json``."""
    os.makedirs(path, exist_ok=True)
    loader = getattr(workflow, "loader", None)
    doc = {
        "format": 1,
        "workflow": workflow.name,
        "input_sample_shape": list(loader.sample_shape())
        if loader is not None else None,
        "units": [_write_unit(u, path) for u in workflow.forwards],
    }
    out = os.path.join(path, "contents.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    return out
