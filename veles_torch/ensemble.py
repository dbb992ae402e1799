"""Ensemble training and evaluation in the port.

Counterpart of ``veles/ensemble.py``: train N instances of a workflow
under different seeds, then average their outputs (softmax
probabilities average into a categorical, MSE outputs into the
ensemble's regression).

    ens = Ensemble(lambda name: mnist.create_workflow(name=name),
                   n_models=3, base_seed=1000, device="cuda")
    ens.train()
    report = ens.evaluate_classification()
    # {"ensemble_error": ..., "member_errors": [...], "n_valid": ...}

Member ``i`` trains after ``prng.seed_all(base_seed + i)``, under a
model-health monitor of its own (one member's losses must not judge
another's). A member's forward is its own eval forward on its device
(the forwards in eval mode, so no dropout draws), under
``torch.no_grad()``; only the outputs, as float32, come to the host.
"""

import numpy
import torch

from veles_torch import model_health, prng
from veles_torch.loader.base import CLASS_VALID
from veles_torch.logger import Logger


class Ensemble(Logger):
    """Trains and evaluates a bag of workflow instances."""

    def __init__(self, workflow_factory, n_models=3, base_seed=1000,
                 device="cuda", name="ensemble"):
        self.name = name
        self.workflow_factory = workflow_factory
        self.n_models = int(n_models)
        self.base_seed = int(base_seed)
        self.device = device
        self.workflows = []

    def train(self):
        """Train every member, each from its own seed. -> the
        workflows."""
        for i in range(self.n_models):
            prng.seed_all(self.base_seed + i)
            wf = self.workflow_factory("%s_m%d" % (self.name, i))
            with model_health.scoped():
                wf.initialize(device=self.device)
                wf.run()
            self.info("member %d trained: best metric %s", i,
                      getattr(wf.decision, "best_metric", None))
            self.workflows.append(wf)
        return self.workflows

    def _member_outputs(self, x):
        """``x`` (rows as the loader holds them) through every member's
        eval forward; -> a list of float32 host arrays."""
        outs = []
        with torch.no_grad():
            for wf in self.workflows:
                rows = torch.as_tensor(
                    numpy.asarray(x, wf.loader.serve_dtype)).to(
                        wf.device.device)
                data = wf.loader.batch_transform(rows, False)
                _, last = wf.step._forward(data, False)
                outs.append(last.float().cpu().numpy())
        return outs

    def predict(self, x):
        """Mean of the members' outputs on the batch ``x``."""
        return numpy.mean(self._member_outputs(x), axis=0)

    def evaluate_classification(self):
        """The ensemble's and each member's error rate over the validation
        class of member 0's loader, in minibatches of its size, the last
        one padded with its last row. As in the reference, the members
        are meant to share a dataset; the synthetic MNIST stand-in is
        drawn from each member's seed, so there the others are judged on
        member 0's rows."""
        loader = self.workflows[0].loader
        labels = numpy.asarray(loader.original_labels)
        # class order: [test | valid | train]
        n_test = loader.class_lengths[0]
        n_valid = loader.class_lengths[CLASS_VALID]
        vx = numpy.asarray(loader.original_data[n_test:n_test + n_valid])
        vy = labels[n_test:n_test + n_valid]
        mb = loader.max_minibatch_size
        member_preds = [[] for _ in self.workflows]
        ens_pred = []
        for lo in range(0, len(vx), mb):
            chunk = vx[lo:lo + mb]
            valid = len(chunk)
            if valid < mb:
                chunk = numpy.concatenate(
                    [chunk, numpy.repeat(chunk[-1:], mb - valid, axis=0)])
            outs = self._member_outputs(chunk)
            for i, out in enumerate(outs):
                member_preds[i].append(numpy.argmax(out, axis=-1)[:valid])
            ens_pred.append(numpy.argmax(
                numpy.mean(outs, axis=0), axis=-1)[:valid])
        ens_pred = numpy.concatenate(ens_pred)
        members = [float(numpy.mean(numpy.concatenate(p) != vy))
                   for p in member_preds]
        return {"ensemble_error": float(numpy.mean(ens_pred != vy)),
                "member_errors": members, "n_valid": int(len(vy))}
