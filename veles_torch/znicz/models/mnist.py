"""MNIST sample of the PyTorch port: 2-layer MLP (All2AllTanh ->
All2AllSoftmax).

Counterpart of ``veles/znicz_tpu/models/mnist.py`` with the same
``root.mnist`` defaults: 784 -> 100 -> 10, minibatch 100, 6000 train /
1000 valid samples. Override from the CLI, e.g.
``python -m veles_torch veles_torch/znicz/models/mnist.py
root.mnist.decision.max_epochs=3 -d cuda --seed 1337``.
"""

import numpy

from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.models import datasets
from veles_torch.znicz.standard_workflow import StandardWorkflow

root.mnist.update({
    "loader": {"minibatch_size": 100,
               "n_train": 6000, "n_valid": 1000},
    "layers": [
        {"type": "all2all_tanh",
         "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.02, "weights_decay": 0.0,
                "gradient_moment": 0.5}},
        {"type": "softmax",
         "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.02, "weights_decay": 0.0,
                "gradient_moment": 0.5}},
    ],
    "decision": {"max_epochs": 5, "fail_iterations": 50},
})


class MnistLoader(FullBatchLoader):
    """Flattened-image full-batch loader; sizes come from kwargs, falling
    back to ``root.mnist.loader``."""

    def __init__(self, workflow=None, n_train=None, n_valid=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self._n_train = n_train
        self._n_valid = n_valid

    def load_data(self):
        tx, ty, vx, vy = datasets.load_mnist(
            n_train=self._n_train or root.mnist.loader.get("n_train", 6000),
            n_valid=self._n_valid or root.mnist.loader.get("n_valid", 1000))
        tx = tx.reshape(len(tx), -1)
        vx = vx.reshape(len(vx), -1)
        # sample order: [test | valid | train]
        self.original_data = numpy.concatenate([vx, tx])
        self.original_labels = numpy.concatenate([vy, ty])
        self.class_lengths = [0, len(vx), len(tx)]


def create_workflow(name="MnistWorkflow"):
    cfg = root.mnist
    return StandardWorkflow(
        name=name, layers=cfg.layers,
        loader_factory=lambda wf: MnistLoader(
            wf, name="loader", minibatch_size=cfg.loader.minibatch_size),
        decision_config=cfg.decision.to_dict())
