"""Whole-dataset-resident loader of the PyTorch port.

Counterpart of ``veles/loader/fullbatch.py``: the dataset is held in
``original_data`` / ``original_labels`` (numpy), uploaded once to the
device, and every minibatch is a gather by index on the device, as the
reference's epoch scan does.
"""

import numpy
import torch

from veles_torch.loader.base import Loader


class FullBatchLoader(Loader):
    """Dataset-in-memory loader; minibatch = row gather."""

    def __init__(self, workflow=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = None
        self.original_labels = None
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

    def device_full_arrays(self, device):
        """Upload the whole dataset once per device."""
        device = torch.device(device)
        if self._device_full is None or self._device_full[0] != device:
            full = {"data": torch.as_tensor(
                self.original_data.astype(self.serve_dtype)).to(device)}
            if self.original_labels is not None:
                full["labels"] = torch.as_tensor(
                    numpy.asarray(self.original_labels, numpy.int64)
                ).to(device)
            self._device_full = (device, full)
        return self._device_full[1]
