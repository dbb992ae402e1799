"""ImageSaver of the port: dumps each minibatch's worst sample.

Counterpart of ``veles/znicz_tpu/image_saver.py`` on the reference's
fused path, where only the minibatch's worst sample is known: after the
decision accounted a minibatch, the sample at the evaluator's
``max_err_idx`` (already in the class's host copy of the metrics: no
extra device read) is written, as the loader's (normalized) original
array, to

    out_dir/epochNNNN/c<cls>_i<global index>_pred-1_true<label>.npy

(``true-1`` without labels), at most ``limit_per_epoch`` files an epoch.
Its counters ride in the checkpoint's ``units`` section
(:meth:`ImageSaver.get_state`), so a resumed run goes on numbering the
epochs it dumps.
"""

import os

import numpy

from veles_torch.znicz.ops.evaluator import METRICS

_MAX_ERR_IDX = METRICS.index("max_err_idx")


class ImageSaver:
    def __init__(self, workflow, out_dir=None, limit_per_epoch=64,
                 name="image_saver"):
        self.workflow = workflow
        self.name = name
        self.out_dir = out_dir
        self.limit_per_epoch = int(limit_per_epoch)
        self._saved_this_epoch = 0
        self._epoch = 0
        self.total_saved = 0

    def _save(self, arr, cls, index, pred, true):
        d = os.path.join(self.out_dir, "epoch%04d" % self._epoch)
        os.makedirs(d, exist_ok=True)
        fname = "c%d_i%d_pred%d_true%d.npy" % (cls, index, pred, true)
        numpy.save(os.path.join(d, fname), arr)
        self._saved_this_epoch += 1
        self.total_saved += 1

    def get_state(self):
        return {"epoch": self._epoch,
                "saved_this_epoch": self._saved_this_epoch,
                "total_saved": self.total_saved}

    def set_state(self, state):
        self._epoch = int(state["epoch"])
        self._saved_this_epoch = int(state["saved_this_epoch"])
        self.total_saved = int(state["total_saved"])

    def on_minibatch(self, cls, indices, valid, row):
        """One accounted minibatch: its class, its rows' global
        ``indices``, the ``valid`` count and its host metrics ``row``."""
        try:
            if self.out_dir is None \
                    or self._saved_this_epoch >= self.limit_per_epoch:
                return
            i = int(row[_MAX_ERR_IDX])
            if i >= valid:
                return
            loader = self.workflow.loader
            gidx = int(indices[i])
            labels = loader.original_labels
            true = -1 if labels is None else int(labels[gidx])
            self._save(numpy.asarray(loader.original_data[gidx]), cls,
                       gidx, -1, true)
        finally:
            # the epoch's last minibatch rolls the directory and the
            # limit over, after it was filed
            if self.workflow.decision.epoch_ended:
                self._epoch += 1
                self._saved_this_epoch = 0
