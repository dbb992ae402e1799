"""CIFAR-10 sample of the port: a small convnet (BASELINE config #2).

Counterpart of ``veles/znicz_tpu/models/cifar10.py`` with the same
``root.cifar`` defaults: conv_relu(32, 5×5, pad 2) → max_pooling(2×2) →
conv_relu(64, 5×5, pad 2) → max_pooling(2×2) → softmax(10), minibatch
100, 5000 train / 1000 validation images (the real CIFAR-10 binaries if
staged, the synthetic stand-in otherwise), NHWC, normalized by the train
set's per-pixel mean and overall std. Override from the CLI, e.g.
``python -m veles_torch veles_torch/znicz/models/cifar10.py
root.cifar.decision.max_epochs=3 -d cuda --seed 1337``.
"""

import numpy

from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.models import datasets
from veles_torch.znicz.standard_workflow import StandardWorkflow

root.cifar.update({
    "loader": {"minibatch_size": 100, "n_train": 5000, "n_valid": 1000},
    "layers": [
        {"type": "conv_relu",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0005,
                "gradient_moment": 0.7}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "conv_relu",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5, "padding": 2},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0005,
                "gradient_moment": 0.7}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "softmax",
         "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0005,
                "gradient_moment": 0.7}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
})


class CifarLoader(FullBatchLoader):
    """NHWC image loader (the CHW source converted once at load), cut to
    ``root.cifar.loader`` n_train / n_valid and normalized as the
    reference does, in numpy (the same bits)."""

    def load_data(self):
        tx, ty, vx, vy = datasets.load_cifar10()
        if tx.shape[1] == 3:                # CHW -> HWC
            tx = tx.transpose(0, 2, 3, 1)
            vx = vx.transpose(0, 2, 3, 1)
        n_train = root.cifar.loader.get("n_train", len(tx))
        n_valid = root.cifar.loader.get("n_valid", len(vx))
        tx, ty = tx[:n_train], ty[:n_train]
        vx, vy = vx[:n_valid], vy[:n_valid]
        mean = tx.mean(axis=0, keepdims=True)
        std = max(float(tx.std()), 1e-6)
        self.original_data = (numpy.concatenate(
            [vx, tx]).astype(numpy.float32) - mean) / std
        self.original_labels = numpy.concatenate([vy, ty])
        self.class_lengths = [0, len(vx), len(tx)]


def create_workflow(name="CifarWorkflow"):
    cfg = root.cifar
    return StandardWorkflow(
        name=name, layers=cfg.layers,
        loader_factory=lambda wf: CifarLoader(
            wf, name="loader", minibatch_size=cfg.loader.minibatch_size),
        decision_config=cfg.decision.to_dict())
