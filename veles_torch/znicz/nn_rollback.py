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

``rollback_count`` and the best loss are checkpointed (the workflow's
``rollback`` section). The check runs at every epoch's end: the
reference's ``interval`` argument, which it stores and never reads, is
not taken. ``rollback_on_divergence`` needs the model-health
plane, which is not ported yet (ROADMAP Queue 1 item 3).
"""

import logging
import math

from veles_torch.loader.base import CLASS_TRAIN, CLASS_VALID

logger = logging.getLogger("veles_torch.rollback")


class NNRollback:
    """Restore the last good epoch-entry state on a loss blow-up."""

    def __init__(self, workflow, lr_cut=0.5, blowup_factor=4.0,
                 rollback_on_divergence=False, name="rollback"):
        if rollback_on_divergence:
            raise NotImplementedError(
                "rollback_on_divergence needs the model-health plane, not "
                "ported yet (ROADMAP Queue 1 item 3)")
        self.workflow = workflow
        self.name = name
        #: multiply the learning rates by this on a rollback
        self.lr_cut = float(lr_cut)
        #: loss > blowup_factor × best loss: roll back (NaN/inf always)
        self.blowup_factor = float(blowup_factor)
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

    def run(self):
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
                self.workflow.restore_stash(self._stash)
                self.rollback_count += 1
                self._cut_lr()
                logger.warning(
                    "loss blow-up: rolled back to the last good weights, "
                    "learning rates cut by %.3g (rollback #%d)",
                    self.lr_cut, self.rollback_count)
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
