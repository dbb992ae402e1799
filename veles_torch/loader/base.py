"""Minibatch schedule of the PyTorch port.

Counterpart of ``veles/loader/base.py``: three sample classes laid out
``[test | valid | train]`` and served in that order each epoch; the
train class is reshuffled every epoch from the ``"loader"`` generator
(the same draws as the reference at the same seed); a class's minibatch
schedule is an index matrix padded by :meth:`Loader.pad_indices`, with
the true row count of each minibatch beside it.
"""

import numpy

from veles_torch import prng

CLASS_TEST, CLASS_VALID, CLASS_TRAIN = 0, 1, 2
TRIAGE = ("test", "validation", "train")


class Loader:
    """Base minibatch scheduler. Subclasses implement :meth:`load_data`
    (set ``class_lengths`` and the dataset) and
    :meth:`device_full_arrays`."""

    def __init__(self, workflow=None, name="loader", minibatch_size=100,
                 shuffle=True, prng_key="loader"):
        self.workflow = workflow
        self.name = name
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle_enabled = bool(shuffle)
        self.prng = prng.get(prng_key)
        #: samples per class: [test, valid, train]
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self._order = []          # [(cls, ndarray of global indices)]

    def load_data(self):
        """Discover the dataset: set ``class_lengths`` and the data."""
        raise NotImplementedError

    def device_full_arrays(self, device):
        """{"data": tensor, "labels": tensor} of the whole dataset on
        ``device``; minibatches are gathered from it by index."""
        raise NotImplementedError

    @property
    def total_samples(self):
        return int(sum(self.class_lengths))

    def class_offset(self, cls):
        return int(sum(self.class_lengths[:cls]))

    def initialize(self):
        if self.total_samples == 0:
            self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s loaded an empty dataset" % self.name)
        self.epoch_number = 0
        self._order = self._generate_order()

    def _class_indices(self, cls):
        off = self.class_offset(cls)
        idx = numpy.arange(off, off + self.class_lengths[cls],
                           dtype=numpy.int32)
        if cls == CLASS_TRAIN and self.shuffle_enabled:
            idx = idx[self.prng.permutation(len(idx))]
        return idx

    def _generate_order(self):
        return [(cls, self._class_indices(cls))
                for cls in (CLASS_TEST, CLASS_VALID, CLASS_TRAIN)
                if self.class_lengths[cls] > 0]

    def next_epoch(self):
        """Advance to the next epoch (draws its train shuffle)."""
        self.epoch_number += 1
        self._order = self._generate_order()

    @staticmethod
    def pad_indices(chunk, size):
        """Pad rows repeat the last index; evaluators mask rows past the
        true count."""
        padded = numpy.empty(size, dtype=numpy.int32)
        padded[:len(chunk)] = chunk
        if len(chunk) < size:
            padded[len(chunk):] = chunk[-1] if len(chunk) else 0
        return padded

    def class_schedule(self, cls):
        """(idx_mat (n_mb, mb) int32, valids (n_mb,) int32) of ``cls`` in
        the current epoch."""
        for c, indices in self._order:
            if c != cls:
                continue
            mb = self.max_minibatch_size
            n_mb = (len(indices) + mb - 1) // mb
            idx_mat = numpy.empty((n_mb, mb), numpy.int32)
            valids = numpy.empty(n_mb, numpy.int32)
            for i in range(n_mb):
                chunk = indices[i * mb:(i + 1) * mb]
                idx_mat[i] = self.pad_indices(chunk, mb)
                valids[i] = len(chunk)
            return idx_mat, valids
        raise ValueError("class %d not in this epoch's order" % cls)

    def epoch_plan(self):
        """[(cls, idx_mat, valids), ...] of the current epoch in serving
        order."""
        return [(cls, *self.class_schedule(cls)) for cls, _ in self._order]
