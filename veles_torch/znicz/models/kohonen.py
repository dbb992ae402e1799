"""Kohonen SOM sample of the PyTorch port.

Counterpart of ``veles/znicz_tpu/models/kohonen.py`` with the same
``root.kohonen`` defaults: an 8×8 map trained on 1000 2-D points drawn
from 6 gaussians (the ``"kohonen_data"`` generator, the reference's draws
bit for bit), minibatch 50, at most 20 epochs, α 0.5 → 0.01 and radius 4
→ 1 over 200 steps. Only the train class exists; the decision stops when
the map stops moving. The workflow has no GD chain: its step body runs
the trainer (``step.py``). Run it with ``python -m veles_torch
veles_torch/znicz/models/kohonen.py -d cuda --seed 1337``.
"""

import numpy
import torch

from veles_torch import prng
from veles_torch.config import root
from veles_torch.loader.base import CLASS_TRAIN
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.decision import DecisionMSE
from veles_torch.znicz.ops.kohonen import KohonenForward, KohonenTrainer
from veles_torch.znicz.standard_workflow import NNWorkflow

root.kohonen.update({
    "loader": {"minibatch_size": 50, "n_samples": 1000},
    "forward": {"shape": (8, 8)},
    "trainer": {"alpha": 0.5, "alpha_min": 0.01, "radius_min": 1.0,
                "decay_steps": 200.0},
    "decision": {"max_epochs": 20},
})


class KohonenLoader(FullBatchLoader):
    """Mixture-of-gaussians point cloud, all of it the train class."""

    def load_data(self):
        gen = prng.get("kohonen_data")
        n = root.kohonen.loader.get("n_samples", 1000)
        centers = gen.uniform(-1.0, 1.0, (6, 2))
        idx = gen.randint(0, 6, n)
        pts = centers[idx] + gen.normal(0.0, 0.08, (n, 2))
        self.original_data = pts.astype(numpy.float32)
        self.class_lengths = [0, 0, n]


class KohonenDecision(DecisionMSE):
    """Stops at ``max_epochs`` or when the train class's mean
    ``weight_delta`` falls below ``weight_delta_eps``. The metric is
    ``weight_delta`` × the minibatch's rows; the trainer exports no loss,
    so the loss reads 0, as the reference's."""

    def __init__(self, name="decision", weight_delta_eps=1e-5, **kwargs):
        super().__init__(name=name, **kwargs)
        self.weight_delta_eps = weight_delta_eps

    @staticmethod
    def minibatch_loss(row):
        return 0.0

    @staticmethod
    def minibatch_metric(n, row):
        return float(row[0]) * n

    def _on_epoch_ended(self):
        super()._on_epoch_ended()
        last = self.last_epoch_metrics[CLASS_TRAIN]
        if last and last["samples"] \
                and self.normalized_metric(last) < self.weight_delta_eps:
            self.complete = True


class KohonenWorkflow(NNWorkflow):
    """loader -> trainer -> decision; the forward classifies (and the SOM
    plotters read its weights)."""

    def __init__(self, name="KohonenWorkflow"):
        super().__init__(name)
        cfg = root.kohonen
        self.loader = KohonenLoader(
            self, name="loader", minibatch_size=cfg.loader.minibatch_size)
        fwd = KohonenForward(name="kohonen_forward", **cfg.forward.to_dict())
        self.trainer = KohonenTrainer(
            name="kohonen_trainer", **cfg.trainer.to_dict()).setup_forward(fwd)
        self.forwards = [fwd]
        self.gds = [self.trainer]
        self.decision = KohonenDecision(**cfg.decision.to_dict())

    def initialize_units(self):
        shape = (self.loader.max_minibatch_size,) \
            + self.loader.sample_shape()
        self.forwards[0].initialize(shape, self.device)
        self.trainer.initialize()

    def step_body(self, data, target, valid, train):
        """A train step runs the trainer: the row (weight_delta, 0, 0, 0);
        an evaluation step classifies and moves nothing. On a mesh every
        rank holds the minibatch's delta and the first rank of the batch
        line reports it (the step's metric gather sums the rows)."""
        if train:
            delta = self.trainer.run(data, valid)
            mesh = self.trainer.mesh
            if mesh is not None and mesh.index(self.trainer.batch_axes):
                delta = torch.zeros_like(delta)
        else:
            self.forwards[0](data)
            delta = torch.zeros((), dtype=torch.float32, device=data.device)
        zero = torch.zeros_like(delta)
        return torch.stack([delta, zero, zero, zero])


def create_workflow(name="KohonenWorkflow"):
    return KohonenWorkflow(name=name)
