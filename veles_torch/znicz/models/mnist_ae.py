"""MnistAE sample of the PyTorch port: a convolutional autoencoder
(conv → average pool → depooling → deconv) trained by MSE against its
input image.

Counterpart of ``veles/znicz_tpu/models/mnist_ae.py`` with the same
``root.mnist_ae`` defaults: (28, 28, 1) -> conv_tanh 9 kernels of 5×5
(24, 24, 9) -> avg pool 2×2 (12, 12, 9) -> depooling back to the conv's
output (``output_shape_source`` 1) -> deconv 9 kernels of 5×5 back to the
image (``output_shape_source`` 0); minibatch 100, 2000 train / 500 valid
images, 4 epochs. The loader serves the image as its own target
(``original_targets`` is ``original_data``), so ``StandardWorkflow``
picks ``EvaluatorMSE`` and ``DecisionMSE``. Run it with
``python -m veles_torch veles_torch/znicz/models/mnist_ae.py -d cuda
--seed 1337 [--export-inference DIR]``.
"""

import numpy

from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.models import datasets
from veles_torch.znicz.standard_workflow import StandardWorkflow

root.mnist_ae.update({
    "loader": {"minibatch_size": 100,
               "n_train": 2000, "n_valid": 500},
    "layers": [
        {"type": "conv_tanh",
         "->": {"n_kernels": 9, "kx": 5, "ky": 5},
         "<-": {"learning_rate": 0.002, "weights_decay": 0.0,
                "gradient_moment": 0.5}},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "depooling", "->": {"output_shape_source": 1}},
        # the deconv's weight gradient sums over every output position a
        # weight touches, hence a learning rate some 100× a dense layer's
        {"type": "deconv",
         "->": {"n_kernels": 9, "kx": 5, "ky": 5,
                "output_shape_source": 0},
         "<-": {"learning_rate": 2e-5, "weights_decay": 0.0,
                "gradient_moment": 0.5}},
    ],
    "decision": {"max_epochs": 4, "fail_iterations": 20},
})


class MnistAELoader(FullBatchLoader):
    """Image in, image out: ``original_targets`` is the data."""

    def __init__(self, workflow=None, n_train=None, n_valid=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self._n_train = n_train
        self._n_valid = n_valid

    def load_data(self):
        cfg = root.mnist_ae.loader
        tx, _, vx, _ = datasets.load_mnist(
            n_train=self._n_train or cfg.get("n_train", 2000),
            n_valid=self._n_valid or cfg.get("n_valid", 500))
        data = numpy.concatenate([vx, tx])[..., None]  # NHWC, C=1
        self.original_data = self.original_targets = data
        self.class_lengths = [0, len(vx), len(tx)]


def create_workflow(name="MnistAEWorkflow"):
    cfg = root.mnist_ae
    return StandardWorkflow(
        name=name, layers=cfg.layers,
        loader_factory=lambda wf: MnistAELoader(
            wf, name="loader", minibatch_size=cfg.loader.minibatch_size),
        decision_config=cfg.decision.to_dict())
