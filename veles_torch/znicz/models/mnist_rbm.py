"""MnistRBM sample of the PyTorch port: CD-1 RBM pretraining on MNIST.

Counterpart of ``veles/znicz_tpu/models/mnist_rbm.py`` with the same
``root.mnist_rbm`` defaults: 784 visible and 64 hidden units, minibatch
100, 2000/500 MNIST images (pixel values in [0, 1] as the visible units'
probabilities), lr 0.05, 5 epochs; ``DecisionMSE`` on the reconstruction
error. The contrastive-divergence chain (``ops/rbm.py``) is not a GD
chain: its step body runs the units in the reference's order and the
update only in train steps. Run it with ``python -m veles_torch
veles_torch/znicz/models/mnist_rbm.py -d cuda --seed 1337``.
"""

import numpy

from veles_torch.config import root
from veles_torch.znicz.decision import DecisionMSE
from veles_torch.znicz.models.mnist import MnistLoader
from veles_torch.znicz.ops.all2all import All2AllSigmoid
from veles_torch.znicz.ops.rbm import (
    BatchWeights, Binarization, EvaluatorRBM, GradientRBM,
    TiedAll2AllSigmoid)
from veles_torch.znicz.standard_workflow import NNWorkflow

root.mnist_rbm.update({
    "loader": {"minibatch_size": 100, "n_train": 2000, "n_valid": 500},
    "rbm": {"n_hidden": 64, "learning_rate": 0.05},
    "decision": {"max_epochs": 5, "fail_iterations": 100},
})


class RBMWorkflow(NNWorkflow):
    """loader -> h_pos -> binarize -> v_neg -> h_neg -> stats ->
    evaluator -> decision, GradientRBM in train steps."""

    def __init__(self, name="RBMWorkflow"):
        super().__init__(name)
        cfg = root.mnist_rbm
        n_hidden = cfg.rbm.n_hidden
        self.loader = MnistLoader(
            self, name="loader", minibatch_size=cfg.loader.minibatch_size,
            n_train=cfg.loader.get("n_train", 2000),
            n_valid=cfg.loader.get("n_valid", 500))
        self.h_pos = All2AllSigmoid(name="h_pos",
                                    output_sample_shape=n_hidden,
                                    weights_stddev=0.05)
        self.binarize = Binarization(name="binarize")
        # the visible size is set from the loader at initialize
        self.v_neg = TiedAll2AllSigmoid(
            name="v_neg", weights_source=self.h_pos, transposed=True,
            output_sample_shape=1)
        self.h_neg = TiedAll2AllSigmoid(
            name="h_neg", weights_source=self.h_pos, bias_source=self.h_pos,
            output_sample_shape=n_hidden)
        self.pos_stats = BatchWeights(name="pos_stats")
        self.neg_stats = BatchWeights(name="neg_stats")
        self.evaluator = EvaluatorRBM(name="evaluator")
        self.decision = DecisionMSE(name="decision",
                                    **cfg.decision.to_dict())
        self.gradient = GradientRBM(name="gradient_rbm",
                                    learning_rate=cfg.rbm.learning_rate)
        self.gradient.hidden_layer = self.h_pos
        self.gradient.visible_layer = self.v_neg
        self.forwards = [self.h_pos, self.binarize, self.v_neg, self.h_neg,
                         self.pos_stats, self.neg_stats]
        self.gds = [self.gradient]

    def initialize_units(self):
        sample = self.loader.sample_shape()
        self.v_neg.neurons = int(numpy.prod(sample))
        v_shape = (self.loader.max_minibatch_size,) + sample
        h_shape = self.h_pos.initialize(v_shape, self.device)
        self.binarize.initialize(h_shape, self.device)
        self.v_neg.initialize(h_shape, self.device)
        self.h_neg.initialize(v_shape, self.device)
        self.pos_stats.initialize(v_shape, self.device)
        self.neg_stats.initialize(v_shape, self.device)

    def step_body(self, data, target, valid, train):
        """CD-1 on one minibatch: the evaluator's row of the
        reconstruction, then in a train step the update."""
        h = self.h_pos(data)
        v_neg = self.v_neg(self.binarize(h))
        h_neg = self.h_neg(v_neg)
        metrics = self.evaluator.run(target, v_neg, valid)
        if train:
            self.gradient.run(self.pos_stats(data, h, valid),
                              self.neg_stats(v_neg, h_neg, valid))
        return metrics


def create_workflow(name="RBMWorkflow"):
    return RBMWorkflow(name=name)
