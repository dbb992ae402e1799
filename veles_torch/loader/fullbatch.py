"""Whole-dataset-resident loader of the PyTorch port.

Counterpart of ``veles/loader/fullbatch.py``: the dataset is held in
``original_data`` / ``original_labels`` / ``original_targets`` (numpy),
uploaded once to the device, and every minibatch is a gather by index on
the device, as the reference's epoch scan does. ``original_targets`` are
the regression targets of an MSE workflow; an autoencoder's alias the
data (``original_targets is original_data``), and then the device holds
one tensor under both keys, so the dataset is uploaded once and the step
gathers each minibatch once.

A normalizer (``normalization_type``) is fitted on the train rows (the
layout is ``[test | valid | train]``, so evaluation rows never reach the
statistics) and applied to the resident data; targets that alias the
data follow it, separate targets keep their own scale.
"""

import logging

import numpy
import torch

from veles_torch import normalization
from veles_torch.loader.base import CLASS_TRAIN, Loader

logger = logging.getLogger("veles_torch.loader")


class FullBatchLoader(Loader):
    """Dataset-in-memory loader; minibatch = row gather."""

    def __init__(self, workflow=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = None
        self.original_labels = None
        #: regression targets (MSE workflows); the data itself for an
        #: autoencoder
        self.original_targets = None
        #: dtype the minibatch is served in
        self.serve_dtype = numpy.float32
        self._device_full = None

    def load_data(self):
        """Default: the originals were assigned before initialize();
        subclasses override to read a dataset."""
        if self.original_data is None:
            raise ValueError("%s: original_data unset and load_data not "
                             "overridden" % self.name)
        if len(self.original_data) != self.total_samples:
            raise ValueError("%s: %d samples but class_lengths sums to %d"
                             % (self.name, len(self.original_data),
                                self.total_samples))

    def apply_normalization(self):
        """Fit the normalizer on the train rows and transform the resident
        data (and targets that alias it)."""
        if isinstance(self.normalizer, normalization.NoneNormalizer):
            return
        train0 = self.class_offset(CLASS_TRAIN)
        if train0 >= len(self.original_data):
            logger.warning("%s: no train samples: %s normalization "
                           "deferred", self.name, self.normalizer.NAME)
            return
        self.normalizer.analyze(self.original_data[train0:])
        aliased = self.original_targets is self.original_data
        self.original_data = self.normalizer.normalize(self.original_data)
        if aliased:
            self.original_targets = self.original_data
        self._device_full = None

    def sample_shape(self):
        return tuple(self.original_data.shape[1:])

    def device_full_arrays(self, device):
        """Upload the whole dataset once per device; aliased targets are
        the data tensor itself."""
        device = torch.device(device)
        if self._device_full is None or self._device_full[0] != device:
            full = {"data": torch.as_tensor(
                self.original_data.astype(self.serve_dtype)).to(device)}
            if self.original_labels is not None:
                full["labels"] = torch.as_tensor(
                    numpy.asarray(self.original_labels, numpy.int64)
                ).to(device)
            if self.original_targets is self.original_data:
                full["targets"] = full["data"]
            elif self.original_targets is not None:
                full["targets"] = torch.as_tensor(
                    self.original_targets.astype(self.serve_dtype)).to(device)
            self._device_full = (device, full)
        return self._device_full[1]
