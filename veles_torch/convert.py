"""State exchange between the JAX package and the port.

The JAX package exports a unit's parameters and optimizer state as
numpy arrays (``export_params()`` / ``export_state()``), keyed by unit
name: ``{"All2AllTanh": {"weights": ..., "bias": ...}, "GDTanh":
{"vel_weights": ..., "vel_bias": ..., "iteration": ...}, ...}``. The
port's ``StandardWorkflow.export_tree`` / ``import_tree`` use the same
names and keys with torch tensors, so both packages can compute from
one state. :func:`tree_from_jax` reads that tree off a JAX-package
workflow object (duck-typed: nothing of the JAX package is imported),
a ZeroFiller's mask included, as the port keys it (``zero_mask`` of the
masked forward); the solver state (``sq_*``, ``acc_*``, ``acc_count``),
a stack's (L, ...) parameters and an MoE FFN's router and experts come
along under their own keys.
"""

import numpy
import torch


def params_from_jax(tree, device="cpu"):
    """{unit: {key: array}} of numpy arrays -> the same tree of torch
    tensors on ``device`` (copies; dtypes kept)."""
    return {unit: {key: torch.tensor(numpy.asarray(value), device=device)
                   for key, value in sub.items()}
            for unit, sub in tree.items()}


def tree_from_jax(workflow):
    """{unit: {key: ndarray}} of a JAX-package workflow: its forwards'
    ``export_params()`` (with a ZeroFiller's mask as ``zero_mask``) and
    its GD units' ``export_state()`` — every weight, bias and velocity,
    the deconvolution's among them."""
    tree = {}
    for f in workflow.forwards:
        sub = dict(f.export_params())
        mask = getattr(f, "zero_mask", None)
        if mask is not None and mask:
            sub["zero_mask"] = numpy.array(mask.map_read().mem,
                                           numpy.float32)
        if sub:
            tree[f.name] = sub
    for gd in workflow.gds:
        if gd is not None and gd.export_state():
            tree[gd.name] = dict(gd.export_state())
    return tree


def params_to_numpy(tree):
    """{unit: {key: tensor}} -> the same tree of numpy arrays (copies on
    the host)."""
    return {unit: {key: value.detach().cpu().numpy().copy()
                   for key, value in sub.items()}
            for unit, sub in tree.items()}
