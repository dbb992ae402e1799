"""NNRollback of the PyTorch port: divergence rollback.

The port's own copy of ``veles/znicz_tpu/nn_rollback.py``. Run after the
decision (and the snapshotter) at each epoch's end, it judges the epoch's
mean loss, the validation class's, else the train class's:

* finite and within ``blowup_factor`` × the best loss seen: when it is a
  new best, keep the workflow's stash of the epoch-entry state (the
  params and solver state the validation loss was measured on, a copy on
  the device: ``stash_state(at_valid=True)``);
* NaN, inf or past the factor: load the stash back (copied, so the stash
  survives a second blow-up) and multiply every GD unit's ``lr_scale`` by
  ``lr_cut`` — applied after the lr policy, so a schedule that replaces
  the base rate is cut too. With no stash yet, only the cut.

With ``rollback_on_divergence`` (``--rollback-on-divergence``) it also
watches the model-health verdict (``model_health.py``) after every class,
where that class's layer stats were just published: when it reads
``diverged``, it restores the stash and cuts the rates as above (only the
cut without a stash) and tells the monitor (``note_rollback``), whose
verdict then steps down to ``suspect``. The reference checks the verdict
after every minibatch; the port's stats reach the host once a class, so
a blow-up the stats catch inside a class is rolled back at its end.

``rollback_count`` and the best loss are checkpointed (the workflow's
``rollback`` section). The check runs at every epoch's end: the
reference's ``interval`` argument, which it stores and never reads, is
not taken.
"""

import logging
import math

from veles_torch import model_health, telemetry
from veles_torch.loader.base import CLASS_TRAIN, CLASS_VALID

logger = logging.getLogger("veles_torch.rollback")


class NNRollback:
    """Restore the last good epoch-entry state on a loss blow-up."""

    def __init__(self, workflow, lr_cut=0.5, blowup_factor=4.0,
                 rollback_on_divergence=False, name="rollback"):
        self.workflow = workflow
        self.name = name
        #: multiply the learning rates by this on a rollback
        self.lr_cut = float(lr_cut)
        #: loss > blowup_factor × best loss: roll back (NaN/inf always)
        self.blowup_factor = float(blowup_factor)
        #: also restore when the model-health verdict reads diverged
        self.rollback_on_divergence = bool(rollback_on_divergence)
        self.rollback_count = 0
        self._stash = None
        self._best_loss = None

    def _epoch_loss(self):
        d = self.workflow.decision
        for cls in (CLASS_VALID, CLASS_TRAIN):
            acc = d.last_epoch_metrics[cls]
            if acc and acc["samples"]:
                return acc["loss"] / acc["samples"]
        return None

    def _cut_lr(self):
        for gd in self.workflow.gds:
            gd.lr_scale *= self.lr_cut

    def _restore(self):
        self.workflow.restore_stash(self._stash)
        self._cut_lr()
        self.rollback_count += 1
        telemetry.record_event(
            "model_rollback", source="nn_rollback",
            rollback=self.rollback_count, lr_cut=self.lr_cut)
        logger.warning(
            "model_rollback: loss blow-up: rolled back to the last good "
            "weights, learning rates cut by %.3g (rollback #%d)",
            self.lr_cut, self.rollback_count)

    def _divergence_tick(self):
        """Restore the stash once the model-health verdict reads
        ``diverged``."""
        monitor = model_health.get_model_monitor()
        verdict, reasons = monitor.verdict_state()
        if verdict != "diverged":
            return
        if self._stash is not None:
            logger.warning("model-health verdict diverged (%s): restoring "
                           "the last good weights",
                           "; ".join(reasons) or "?")
            self._restore()
        else:
            self._cut_lr()
            logger.warning(
                "model-health verdict diverged (%s) before any good "
                "stash: learning rates cut by %.3g",
                "; ".join(reasons) or "?", self.lr_cut)
        monitor.note_rollback()

    def run(self):
        if self.rollback_on_divergence:
            self._divergence_tick()
        if not self.workflow.decision.epoch_ended:
            return
        loss = self._epoch_loss()
        if loss is None:
            return
        blown = not math.isfinite(loss) or (
            self._best_loss is not None
            and loss > self.blowup_factor * self._best_loss)
        if blown:
            if self._stash is not None:
                self._restore()
            else:
                # never stash a blown state: a NaN best loss would
                # disable every later comparison
                self._cut_lr()
                logger.warning("loss blow-up before any good epoch: no "
                               "stash to restore; learning rates cut by "
                               "%.3g", self.lr_cut)
            return
        if self._best_loss is None or loss < self._best_loss:
            self._best_loss = loss
            self._stash = self.workflow.stash_state(at_valid=True)

    def get_state(self):
        return {"rollback_count": self.rollback_count,
                "best_loss": None if self._best_loss is None
                else float(self._best_loss)}

    def set_state(self, state):
        self.rollback_count = int(state.get("rollback_count", 0))
        best = state.get("best_loss")
        self._best_loss = None if best is None else float(best)
