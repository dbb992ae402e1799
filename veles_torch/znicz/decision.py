"""Decisions of the PyTorch port: the training loop's stop criteria
and history.

Counterparts of ``DecisionGD`` and ``DecisionMSE`` in
``veles/znicz_tpu/decision.py``: per sample class they accumulate each
minibatch's metric and loss, judge improvement on the validation class
(train when there is none), keep a per-epoch ``history`` of the same
shape as the reference's, and set ``complete`` at ``max_epochs`` or
after ``fail_iterations`` epochs without improvement. ``DecisionGD``'s
metric is the number of errors, ``DecisionMSE``'s the loss times the
minibatch's sample count (so its normalised metric is the mean loss).

As in the reference, ``improved`` and ``epoch_ended`` describe the last
minibatch accounted (a new best on the judged class's last minibatch,
the epoch's last minibatch), ``last_epoch_metrics`` holds the finished
epoch's per-class sums, each epoch's end feeds the judged class's mean
loss to the model-health monitor (``observe_loss``), and :meth:`DecisionGD.get_state` /
:meth:`DecisionGD.set_state` carry the reference's checkpoint keys.

Inside an epoch, :meth:`DecisionGD.get_state` gives the state as the
epoch began: a resume restarts the epoch and accounts its classes again,
so a checkpoint taken after the validation class was judged must not
carry that judgement, or the resumed run would judge the same metric a
second time (no improvement, one more epoch since the best). The
reference checkpoints the judged state; a resume of its checkpoint
judges twice.
"""

import logging

import numpy

from veles_torch import model_health
from veles_torch.loader.base import (
    CLASS_TEST, CLASS_VALID, CLASS_TRAIN, TRIAGE)

logger = logging.getLogger("veles_torch.decision")


class DecisionGD:
    """Epoch bookkeeping + stop criteria; metric = number of errors."""

    @staticmethod
    def minibatch_loss(row):
        """The loss of a minibatch's host metrics row (``METRICS``
        layout: loss, n_err, max_err, max_err_idx)."""
        return float(row[0])

    @staticmethod
    def minibatch_metric(n, row):
        """The metric a minibatch of ``n`` valid rows adds."""
        return int(row[1])

    def __init__(self, name="decision", max_epochs=None,
                 fail_iterations=100):
        self.name = name
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        #: the judged class's metric hit a new best on the last minibatch
        self.improved = False
        #: the last minibatch ended an epoch
        self.epoch_ended = False
        self.epoch_number = 0
        self.minibatch_count = 0
        self.epoch_metrics = [None, None, None]
        #: the finished epoch's per-class sums
        self.last_epoch_metrics = [None, None, None]
        self.best_metric = numpy.inf
        self.best_epoch = -1
        self._epochs_since_best = 0
        #: one summary dict per finished epoch
        self.history = []
        #: get_state() as the epoch in flight began (None between epochs)
        self._entry_state = None

    def on_minibatch(self, cls, n, row, last_minibatch, epoch_ended,
                     has_valid):
        """Account one served minibatch of ``n`` valid rows and its host
        metrics ``row``."""
        if self._entry_state is None:
            self._entry_state = self._state()
        self.improved = self.epoch_ended = False
        self.minibatch_count += 1
        acc = self.epoch_metrics[cls]
        if acc is None:
            acc = self.epoch_metrics[cls] = {
                "samples": 0, "loss": 0.0, "metric": 0.0}
        acc["samples"] += n
        acc["metric"] += self.minibatch_metric(n, row)
        acc["loss"] += self.minibatch_loss(row) * n
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
                self.improved = True
            else:
                self._epochs_since_best += 1

    def _on_epoch_ended(self):
        self._entry_state = None
        self.epoch_ended = True
        self.last_epoch_metrics = list(self.epoch_metrics)
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
        # the model-health plane's evaluation tick: the judged class's
        # mean loss (NNRollback's class preference)
        for cls in (CLASS_VALID, CLASS_TRAIN):
            acc = self.epoch_metrics[cls]
            if acc and acc["samples"]:
                model_health.get_model_monitor().observe_loss(
                    acc["loss"] / acc["samples"], epoch=self.epoch_number)
                break
        self.epoch_metrics = [None, None, None]
        self.epoch_number += 1
        if self.max_epochs is not None \
                and self.epoch_number >= self.max_epochs:
            self.complete = True
        if self._epochs_since_best >= self.fail_iterations:
            self.complete = True

    def get_state(self):
        """The checkpoint keys: as the epoch in flight began, or now,
        between epochs."""
        if self._entry_state is not None:
            return dict(self._entry_state)
        return self._state()

    def _state(self):
        return {"epoch_number": self.epoch_number,
                "minibatch_count": self.minibatch_count,
                "best_metric": float(self.best_metric),
                "best_epoch": self.best_epoch,
                "epochs_since_best": self._epochs_since_best,
                "history": list(self.history)}

    def set_state(self, state):
        self.epoch_number = int(state["epoch_number"])
        self.minibatch_count = int(state["minibatch_count"])
        self.best_metric = float(state["best_metric"])
        self.best_epoch = int(state["best_epoch"])
        self._epochs_since_best = int(state["epochs_since_best"])
        self.history = list(state["history"])
        self.epoch_metrics = [None, None, None]
        self._entry_state = None


class DecisionMSE(DecisionGD):
    """Regression/LM decision: metric = loss × sample count."""

    @classmethod
    def minibatch_metric(cls, n, row):
        return cls.minibatch_loss(row) * n


def summary_line(summary):
    """The one-line text of an epoch summary."""
    parts = ["epoch %d" % summary["epoch"]]
    for cls in (CLASS_TRAIN, CLASS_VALID, CLASS_TEST):
        s = summary.get(TRIAGE[cls])
        if s:
            parts.append("%s: metric=%.6g loss=%.6g"
                         % (TRIAGE[cls], s["metric"], s["loss"]))
    return " | ".join(parts)
