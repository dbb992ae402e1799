"""Classification decision of the PyTorch port: the training loop's
stop criteria and history.

Counterpart of ``DecisionGD`` in ``veles/znicz_tpu/decision.py``: per
sample class it accumulates each minibatch's ``n_err`` and loss, judges
improvement on the validation class (train when there is none), keeps a
per-epoch ``history`` of the same shape as the reference's, and sets
``complete`` at ``max_epochs`` or after ``fail_iterations`` epochs
without improvement.
"""

import logging

import numpy

from veles_torch.loader.base import (
    CLASS_TEST, CLASS_VALID, CLASS_TRAIN, TRIAGE)

logger = logging.getLogger("veles_torch.decision")


class DecisionGD:
    """Epoch bookkeeping + stop criteria; metric = number of errors."""

    def __init__(self, name="decision", max_epochs=None,
                 fail_iterations=100):
        self.name = name
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.epoch_number = 0
        self.epoch_metrics = [None, None, None]
        self.best_metric = numpy.inf
        self.best_epoch = -1
        self._epochs_since_best = 0
        #: one summary dict per finished epoch
        self.history = []

    def on_minibatch(self, cls, n, n_err, loss, last_minibatch,
                     epoch_ended, has_valid):
        """Account one served minibatch of ``n`` valid rows."""
        acc = self.epoch_metrics[cls]
        if acc is None:
            acc = self.epoch_metrics[cls] = {
                "samples": 0, "loss": 0.0, "metric": 0.0}
        acc["samples"] += n
        acc["metric"] += n_err
        acc["loss"] += float(loss) * n
        if last_minibatch and cls in (CLASS_VALID, CLASS_TRAIN):
            self._on_class_ended(cls, has_valid)
        if epoch_ended:
            self._on_epoch_ended()

    def normalized_metric(self, acc):
        # error fraction in [0,1]
        return acc["metric"] / max(acc["samples"], 1)

    def _on_class_ended(self, cls, has_valid):
        acc = self.epoch_metrics[cls]
        judge = CLASS_VALID if has_valid else CLASS_TRAIN
        if cls == judge and acc["samples"]:
            value = self.normalized_metric(acc)
            if value < self.best_metric - 1e-12:
                self.best_metric = value
                self.best_epoch = self.epoch_number
                self._epochs_since_best = 0
            else:
                self._epochs_since_best += 1

    def _on_epoch_ended(self):
        summary = {"epoch": self.epoch_number}
        for cls in (CLASS_TEST, CLASS_VALID, CLASS_TRAIN):
            acc = self.epoch_metrics[cls]
            if acc and acc["samples"]:
                summary[TRIAGE[cls]] = {
                    "metric": self.normalized_metric(acc),
                    "loss": acc["loss"] / acc["samples"],
                    "samples": acc["samples"],
                }
        self.history.append(summary)
        logger.info(summary_line(summary))
        self.epoch_metrics = [None, None, None]
        self.epoch_number += 1
        if self.max_epochs is not None \
                and self.epoch_number >= self.max_epochs:
            self.complete = True
        if self._epochs_since_best >= self.fail_iterations:
            self.complete = True


def summary_line(summary):
    """The one-line text of an epoch summary."""
    parts = ["epoch %d" % summary["epoch"]]
    for cls in (CLASS_TRAIN, CLASS_VALID, CLASS_TEST):
        s = summary.get(TRIAGE[cls])
        if s:
            parts.append("%s: metric=%.6g loss=%.6g"
                         % (TRIAGE[cls], s["metric"], s["loss"]))
    return " | ".join(parts)
