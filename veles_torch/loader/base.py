"""Minibatch schedule of the PyTorch port.

Counterpart of ``veles/loader/base.py``: three sample classes laid out
``[test | valid | train]`` and served in that order each epoch; the
train class is reshuffled every epoch from the ``"loader"`` generator
(the same draws as the reference at the same seed); a class's minibatch
schedule is an index matrix padded by :meth:`Loader.pad_indices`, with
the true row count of each minibatch beside it. A loader takes the
reference's ``normalization_type`` / ``normalization_parameters`` and
builds its normalizer (``veles_torch/normalization.py``); a loader that
cannot apply one refuses it at initialize, as the reference's does.

An epoch's order is drawn when it is first served, so the generator's
state before the draw is the epoch's entry state. :meth:`Loader.get_state`
gives the epoch number, that entry state (the PCG64 ``bit_generator``
state, the reference's key ``prng_state``) and the fitted normalizer;
:meth:`Loader.set_state` restores them and restarts the epoch, drawing
its order again from the restored state, as the reference's does.

The wire of the master/slave mode (``distributable.py``, ``server.py``):
on the master, :meth:`Loader.master_start_epoch` fills the job queue of
one epoch, one ``(cls, [indices])`` job per minibatch, the train class
shuffled by a generator of its own (``"<name>.dist"``, seeded
``state_seed + 0x9E3779B9``, the reference's derivation, so a port
master and a reference master hand out the same jobs in the same
order); :meth:`Loader.generate_data_for_slave` pops the next job into
the slave's in-flight list, :meth:`Loader.apply_data_from_slave` retires
it and :meth:`Loader.drop_slave` requeues a dead slave's jobs at the
front. On a slave, :meth:`Loader.apply_data_from_master` takes the job's
index list: ``job`` then holds ``(cls, padded indices, valid rows)``,
padded as the class schedule pads, for the step's one-job entry
(``TorchStep.run_job``).
"""

import logging

import numpy

from veles_torch import normalization, prng
from veles_torch.distributable import IDistributable

logger = logging.getLogger("veles_torch.loader")

CLASS_TEST, CLASS_VALID, CLASS_TRAIN = 0, 1, 2
TRIAGE = ("test", "validation", "train")


class Loader(IDistributable):
    """Base minibatch scheduler. Subclasses implement :meth:`load_data`
    (set ``class_lengths`` and the dataset) and
    :meth:`device_full_arrays`; a streaming loader
    (``veles_torch/loader/stream.py``) sets ``supports_streaming`` and
    materializes windows instead."""

    #: the step uploads windows of this loader's minibatches in place of
    #: gathering from device-resident arrays
    supports_streaming = False

    def __init__(self, workflow=None, name="loader", minibatch_size=100,
                 shuffle=True, prng_key="loader", normalization_type=None,
                 normalization_parameters=None):
        self.workflow = workflow
        self.name = name
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle_enabled = bool(shuffle)
        self.prng = prng.get(prng_key)
        #: fitted on the train rows, applied by :meth:`apply_normalization`
        self.normalizer = normalization.factory(
            normalization_type, **(normalization_parameters or {}))
        self._normalization_applied = False
        #: samples per class: [test, valid, train]
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        #: [(cls, ndarray of global indices)] of the current epoch, None
        #: until it is drawn
        self._order = None
        #: the generator's state before the current order was drawn
        self._entry_state = None
        #: master side: the epoch's queued ``(cls, [indices])`` jobs and
        #: each slave's in-flight ones
        self._pending_jobs = []
        self._inflight = {}
        #: slave side: the job served by the master, ``(cls, padded
        #: int32 indices, valid rows)``, or None
        self.job = None

    def load_data(self):
        """Discover the dataset: set ``class_lengths`` and the data."""
        raise NotImplementedError

    def device_full_arrays(self, device):
        """{"data": tensor, "labels" and/or "targets": tensor} of the whole
        dataset on ``device``; minibatches are gathered from it by
        index."""
        raise NotImplementedError

    def stop(self):
        """Stop the loader's threads (a streaming loader's pools); the
        base has none."""

    def apply_normalization(self):
        """Fit and apply ``normalizer`` (a subclass's hook). The base
        refuses any normalizer but ``none``: a configured
        ``normalization_type`` that no code applies would train on raw
        data without a word."""
        if not isinstance(self.normalizer, normalization.NoneNormalizer):
            raise NotImplementedError(
                "%s does not implement pluggable normalization "
                "(normalization_type=%r); use a full-batch loader or "
                "normalize in load_data" % (type(self).__name__,
                                            self.normalizer.NAME))

    def sample_shape(self):
        """Shape of one sample as the first forward unit receives it
        (after :meth:`batch_transform`)."""
        raise NotImplementedError

    def batch_transform(self, data, train):
        """The minibatch ``data`` gathered on the device -> what the
        forwards take (the reference's ``xla_batch_transform``); ``train``
        is True for a train minibatch. The identity by default."""
        return data

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
        if not self._normalization_applied:
            self.apply_normalization()
            self._normalization_applied = True
        self.epoch_number = 0
        self._order = None

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

    def _current_order(self):
        if self._order is None:
            self._entry_state = self.prng_state()
            self._order = self._generate_order()
        return self._order

    def next_epoch(self):
        """Advance to the next epoch (its train shuffle is drawn when it
        is first served)."""
        self.epoch_number += 1
        self._order = None

    def prng_state(self):
        """The shuffle generator's PCG64 state (a fresh dict)."""
        return self.prng._gen.bit_generator.state

    # -- checkpoint support: a restore restarts the epoch ---------------

    def get_state(self):
        """{epoch_number, prng_state (at the epoch's entry), normalizer}:
        the reference's keys."""
        entry = self._entry_state if self._order is not None \
            else self.prng_state()
        return {"epoch_number": self.epoch_number,
                "prng_state": dict(entry),
                "normalizer": self.normalizer.state()}

    def set_state(self, state):
        """Restore :meth:`get_state`'s values and restart the epoch: its
        order is drawn again from the restored generator state. A
        checkpoint's normalizer of another type replaces the configured
        one (warned)."""
        self.epoch_number = int(state["epoch_number"])
        self.prng._gen.bit_generator.state = state["prng_state"]
        norm = state.get("normalizer")
        if norm:
            name = norm.get("__name__")
            if name and name != self.normalizer.NAME:
                logger.warning("%s: restoring the %r normalizer of the "
                               "checkpoint (configured: %r)", self.name,
                               name, self.normalizer.NAME)
                self.normalizer = normalization.from_state(norm)
            else:
                self.normalizer.set_state(norm)
        self._order = None

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
        for c, indices in self._current_order():
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
        return [(cls, *self.class_schedule(cls))
                for cls, _ in self._current_order()]

    # -- IDistributable: minibatch index lists over the wire ----------

    def generate_data_for_slave(self, slave=None):
        """Pop the next job; ``None`` when the epoch's queue is empty
        (the master then starts the next epoch)."""
        if not self._pending_jobs:
            return None
        job = self._pending_jobs.pop(0)
        self._inflight.setdefault(slave, []).append(job)
        return job

    def _ensure_dist_prng(self):
        """The master-side shuffle generator, made on first use: the one
        place that derives it, for the epoch start and a restarted
        master's restore alike."""
        if not hasattr(self, "_dist_prng"):
            self._dist_prng = prng.RandomGenerator(
                "%s.dist" % self.name, self.prng.state_seed + 0x9E3779B9)
        return self._dist_prng

    def master_start_epoch(self):
        """Master side: fill the job queue of one epoch from the
        master's own shuffle generator (the serving generator is left
        as it is)."""
        self._ensure_dist_prng()
        mb = self.max_minibatch_size
        for cls in (CLASS_TEST, CLASS_VALID, CLASS_TRAIN):
            if self.class_lengths[cls] == 0:
                continue
            off = self.class_offset(cls)
            indices = numpy.arange(off, off + self.class_lengths[cls],
                                   dtype=numpy.int32)
            if cls == CLASS_TRAIN and self.shuffle_enabled:
                indices = indices[
                    self._dist_prng.permutation(len(indices))]
            for lo in range(0, len(indices), mb):
                self._pending_jobs.append(
                    (cls, indices[lo:lo + mb].tolist()))

    def apply_data_from_master(self, data):
        if data is None:
            return
        cls, idx_list = data
        chunk = numpy.asarray(idx_list, dtype=numpy.int32)
        self.job = (int(cls), self.pad_indices(chunk,
                                               self.max_minibatch_size),
                    len(chunk))

    def generate_data_for_master(self):
        return None

    def apply_data_from_slave(self, data, slave=None):
        if self._inflight.get(slave):
            self._inflight[slave].pop(0)

    def drop_slave(self, slave=None):
        """Requeue a dead slave's in-flight jobs at the front; -> how
        many."""
        jobs = self._inflight.pop(slave, [])
        for job in jobs:
            self._pending_jobs.insert(0, job)
        return len(jobs)
