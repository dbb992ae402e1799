"""State exchange between the JAX package and the port.

The JAX package exports a unit's parameters and optimizer state as
numpy arrays (``export_params()`` / ``export_state()``), keyed by unit
name: ``{"All2AllTanh": {"weights": ..., "bias": ...}, "GDTanh":
{"vel_weights": ..., "vel_bias": ..., "iteration": ...}, ...}``. The
port's ``StandardWorkflow.export_tree`` / ``import_tree`` use the same
names and keys with torch tensors, so both packages can compute from
one state.
"""

import numpy
import torch


def params_from_jax(tree, device="cpu"):
    """{unit: {key: array}} of numpy arrays -> the same tree of torch
    tensors on ``device`` (copies; dtypes kept)."""
    return {unit: {key: torch.tensor(numpy.asarray(value), device=device)
                   for key, value in sub.items()}
            for unit, sub in tree.items()}


def params_to_numpy(tree):
    """{unit: {key: tensor}} -> the same tree of numpy arrays (copies on
    the host)."""
    return {unit: {key: value.detach().cpu().numpy().copy()
                   for key, value in sub.items()}
            for unit, sub in tree.items()}
