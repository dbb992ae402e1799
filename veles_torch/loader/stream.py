"""Streaming loaders of the PyTorch port: datasets that do not live on the
device.

Counterpart of ``veles/loader/stream.py``. A streaming loader
materializes windows of stacked minibatches on the host (decode and
augmentation in a thread pool) and :class:`veles_torch.znicz.step.
TorchStep` uploads each window and runs its minibatches
(``supports_streaming``; the step's stream path). The reference's
numpy-oracle methods (``fill_minibatch``, ``create_minibatch_data``)
have no counterpart: the port has no host oracle, every minibatch runs
through the step.

:class:`ContinualStreamLoader` is the ingest half of the continual loop
(``veles_torch/continual.py``): an endless :class:`StreamSource` served
as rounds of ``round_samples``, with a bounded prefetch plane (a daemon
producer thread, a block buffer keyed by stream position, retry forever)
and the stream cursor in the checkpoint, in the reference's format. On a
master of the master/slave mode (``server.py``) it hands out its rounds
as jobs by shard: with ``shards`` > 1 each train job belongs to shard
``(first index // minibatch) % shards``, each slave is assigned a shard
of its own when it first asks (sticky while it lives), and a shard with
no live owner is stolen so a dead slave never wedges a round;
``master_start_epoch`` claims the round (the cursor moves on as the
queue fills, as the reference's does).
"""

import concurrent.futures
import logging
import threading
import time

import numpy

from veles_torch import telemetry
from veles_torch.loader.base import (CLASS_TEST, CLASS_TRAIN, CLASS_VALID,
                                     Loader)

logger = logging.getLogger("veles_torch.loader")


class StreamLoader(Loader):
    """Streams minibatch windows; subclasses produce individual samples.

    Contract: implement :meth:`load_data` (set ``class_lengths``),
    :meth:`sample_spec` and :meth:`materialize_samples` (global indices
    -> dict of per-sample arrays). The decode pool and window stacking
    live here; :meth:`stop` shuts the pool down (a later window makes a
    new one).
    """

    supports_streaming = True
    #: True when :meth:`materialize_samples` is vectorized numpy: the
    #: window is produced in ONE call (fanning rows out to decode threads
    #: would only contend for the interpreter lock). File loaders, whose
    #: decode releases the lock in zlib and numpy, leave it False.
    window_vectorized = False
    #: the regression targets are the data itself (an autoencoder's): a
    #: window then carries no ``targets`` and the step's target is the
    #: minibatch's data
    targets_are_data = False

    def __init__(self, workflow=None, prefetch_workers=8, **kwargs):
        super().__init__(workflow, **kwargs)
        self.prefetch_workers = int(prefetch_workers)
        self._pool = None
        self._pool_lock = threading.Lock()

    @property
    def pool(self):
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.prefetch_workers,
                    thread_name_prefix="%s-decode" % self.name)
            return self._pool

    # -- subclass surface ---------------------------------------------

    def materialize_samples(self, indices, train):
        """dict name -> (len(indices), ...) host arrays for the GLOBAL
        sample ``indices``; ``train`` is the phase of the class being
        materialized (augmentation reads it, never a live phase)."""
        raise NotImplementedError

    def sample_spec(self):
        """dict name -> (shape, dtype) of ONE streamed sample (what the
        host ships: uint8 images travel as bytes)."""
        raise NotImplementedError

    def sample_shape(self):
        return tuple(self.sample_spec()["data"][0])

    def device_full_arrays(self, device):
        raise NotImplementedError(
            "%s streams its data: it has no device-resident arrays"
            % self.name)

    # -- windows ---------------------------------------------------------

    def materialize_window(self, cls, idx_mat):
        """dict name -> (B, mb, ...) host arrays of the B minibatches of
        ``idx_mat`` (global indices) of class ``cls``: one vectorized
        call when ``window_vectorized``, else one pool future per
        minibatch. ``train`` comes from ``cls``."""
        train = cls == CLASS_TRAIN
        idx_mat = numpy.asarray(idx_mat)
        if self.window_vectorized:
            b, mb = idx_mat.shape
            flat = self.materialize_samples(idx_mat.reshape(-1), train)
            return {name: arr.reshape((b, mb) + arr.shape[1:])
                    for name, arr in flat.items()}
        futures = [self.pool.submit(self.materialize_samples, row, train)
                   for row in idx_mat]
        batches = [f.result() for f in futures]
        return {name: numpy.stack([b[name] for b in batches])
                for name in batches[0]}

    def stop(self):
        """Shut the decode pool down (queued work cancelled)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


class ArrayStreamLoader(StreamLoader):
    """Streaming view over host arrays: nothing is device-resident, every
    window travels the host -> device link. ``targets`` may be ``data``
    itself (an autoencoder's), which is then shipped once."""

    window_vectorized = True

    def __init__(self, workflow=None, data=None, labels=None, targets=None,
                 class_lengths=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self._data = data
        self._labels = labels
        self._targets = targets
        self.targets_are_data = targets is not None and targets is data
        if class_lengths is not None:
            self.class_lengths = list(class_lengths)

    def load_data(self):
        if self._data is None:
            raise ValueError("%s: data unset" % self.name)

    def _arrays(self):
        out = {"data": self._data}
        if self._labels is not None:
            out["labels"] = self._labels
        if self._targets is not None and not self.targets_are_data:
            out["targets"] = self._targets
        return out

    def sample_spec(self):
        return {name: (arr.shape[1:], arr.dtype)
                for name, arr in self._arrays().items()}

    def materialize_samples(self, indices, train):
        return {name: arr[indices] for name, arr in self._arrays().items()}


# -- continual ingest ----------------------------------------------------


class StreamSource:
    """A seekable, unbounded sample feed. ``fetch(start, count)`` may
    block until the positions exist and must serve any position already
    produced (a resume fetches again)."""

    def spec(self):
        """dict name -> (per-sample shape tuple, dtype)."""
        raise NotImplementedError

    def fetch(self, start, count):
        """dict name -> (count, ...) host arrays of stream positions
        ``[start, start + count)``."""
        raise NotImplementedError

    def close(self):
        pass


class ArraySource(StreamSource):
    """Cycles over fixed arrays: position ``p`` serves row
    ``p % len(data)``."""

    def __init__(self, data, labels=None, targets=None):
        self._arrays = {"data": numpy.asarray(data)}
        if labels is not None:
            self._arrays["labels"] = numpy.asarray(labels)
        if targets is not None:
            self._arrays["targets"] = numpy.asarray(targets)

    def spec(self):
        return {name: (arr.shape[1:], arr.dtype)
                for name, arr in self._arrays.items()}

    def fetch(self, start, count):
        n = len(self._arrays["data"])
        idx = numpy.arange(start, start + count, dtype=numpy.int64) % n
        return {name: arr[idx] for name, arr in self._arrays.items()}


class ContinualStreamLoader(StreamLoader):
    """An endless stream served as training rounds.

    Each epoch (a "round") takes the next ``round_samples`` stream
    positions; the stream's first ``valid_samples`` positions are a
    pinned validation set, so the decision keeps judging improvement.
    Global train index ``g`` maps statelessly to stream position
    ``g - class_offset(CLASS_TRAIN)``. The cursor advances by
    ``round_samples`` where the port's loader ends an epoch
    (:meth:`next_epoch`), so a checkpoint at an epoch's end resumes at
    the next round and one taken while a round runs restarts that round
    (no replay, no skip).

    Prefetch: a daemon producer thread pulls blocks of
    ``max_minibatch_size`` samples from the source into a buffer keyed by
    block (at most ``prefetch_blocks`` ahead of demand; blocks below the
    served floor are evicted); a failed fetch is counted
    (``veles_stream_fetch_failures_total``) and retried after
    ``fetch_retry_s``, forever. ``last_ingest_wall`` is the wall time of
    the newest sample that arrived: the continual loop's ingest clock.
    """

    window_vectorized = True
    #: seconds :meth:`stop` waits for the producer's fetch in flight
    STOP_TIMEOUT = 30.0

    def __init__(self, workflow=None, source=None, round_samples=1024,
                 valid_samples=0, shards=1, prefetch_blocks=16,
                 fetch_retry_s=0.5, **kwargs):
        kwargs.setdefault("shuffle", False)   # stream order is the order
        super().__init__(workflow, **kwargs)
        self.source = source
        self.round_samples = int(round_samples)
        self.valid_samples = int(valid_samples)
        #: master side: train jobs are dealt by shard, one per slave
        self.shards = max(1, int(shards))
        self._slave_shards = {}
        self.prefetch_blocks = max(2, int(prefetch_blocks))
        self.fetch_retry_s = float(fetch_retry_s)
        #: stream position where the current round starts
        self.cursor_base = None
        #: wall time the newest sample arrived from the source
        self.last_ingest_wall = 0.0
        self._valid = None
        # the prefetch plane, all guarded by _cond
        self._cond = threading.Condition()
        self._blocks = {}            # block id -> dict name -> arrays
        self._next_block = None
        self._demand_block = -1
        self._served_floor = 0       # positions below this are done
        #: start -> end of windows grabbed above the floor (the step
        #: stages two windows at once, so they may complete out of order)
        self._grabbed = {}
        self._producer = None
        self._producer_stop = False
        self._reset_seq = 0
        self._tele_fetch_failures = telemetry.LazyChild(
            lambda: telemetry.counter(
                "veles_stream_fetch_failures_total",
                "Ingest-source fetches that failed and were retried "
                "(a stalled stream grows this while staleness climbs)",
                ("loader",)).labels(self.name))
        self._tele_buffer = telemetry.LazyChild(
            lambda: telemetry.gauge(
                "veles_stream_prefetch_blocks",
                "Sample blocks resident in the prefetch buffer",
                ("loader",)).labels(self.name))

    @property
    def block_samples(self):
        return self.max_minibatch_size

    def load_data(self):
        if self.source is None:
            raise ValueError("%s: source unset" % self.name)
        if self.valid_samples:
            self._valid = self.source.fetch(0, self.valid_samples)
            with self._cond:
                self.last_ingest_wall = time.time()
        self.class_lengths = [0, self.valid_samples, self.round_samples]
        if self.cursor_base is None:
            # a fresh start: the stream's head fed the validation set
            self.cursor_base = self.valid_samples
            with self._cond:
                self._served_floor = self.cursor_base

    def sample_spec(self):
        return {name: (tuple(shape), numpy.dtype(dtype))
                for name, (shape, dtype) in self.source.spec().items()}

    # -- rounds ----------------------------------------------------------

    def _generate_order(self):
        order = [(cls, self._class_indices(cls))
                 for cls in (CLASS_TEST, CLASS_VALID)
                 if self.class_lengths[cls] > 0]
        off = self.class_offset(CLASS_TRAIN)
        start = int(self.cursor_base)
        # int32 is the reference's index plumbing: the same ~2.1e9
        # lifetime sample ceiling, refused in the open
        if start + self.round_samples + off > numpy.iinfo(numpy.int32).max:
            raise OverflowError(
                "%s: stream position %d overflows the int32 index "
                "plumbing" % (self.name, start + self.round_samples))
        order.append((CLASS_TRAIN, numpy.arange(
            off + start, off + start + self.round_samples,
            dtype=numpy.int32)))
        return order

    def next_epoch(self):
        """The round's stream window is consumed: the next round starts
        ``round_samples`` further on."""
        self.cursor_base += self.round_samples
        super().next_epoch()

    # -- the prefetch plane ----------------------------------------------

    def _ensure_producer(self, first_block):
        if self._producer is not None and self._producer.is_alive():
            return
        if self._next_block is None:
            # from the lowest position not served yet, whichever window
            # asks first
            self._next_block = min(int(first_block),
                                   self._served_floor // self.block_samples)
        self._producer_stop = False
        self._producer = threading.Thread(
            target=self._produce, args=(self._reset_seq,), daemon=True,
            name="%s-ingest" % self.name)
        self._producer.start()

    def _produce(self, seq):
        bs = self.block_samples
        while True:
            with self._cond:
                while (not self._producer_stop
                       and seq == self._reset_seq
                       and len(self._blocks) >= self.prefetch_blocks
                       and self._next_block > self._demand_block):
                    self._cond.wait(1.0)
                if self._producer_stop or seq != self._reset_seq:
                    return
                block = self._next_block
            try:
                batch = self.source.fetch(block * bs, bs)
            except Exception as exc:
                self._tele_fetch_failures.get().inc()
                logger.warning("%s: ingest fetch @%d failed (%s: %s) — "
                               "retrying", self.name, block * bs,
                               type(exc).__name__, exc)
                with self._cond:
                    self._cond.wait_for(
                        lambda: self._producer_stop
                        or seq != self._reset_seq, self.fetch_retry_s)
                continue
            with self._cond:
                if self._producer_stop or seq != self._reset_seq:
                    return
                self._blocks[block] = batch
                self._next_block = block + 1
                self.last_ingest_wall = time.time()
                self._tele_buffer.get().set(len(self._blocks))
                self._cond.notify_all()

    def _gather_stream(self, positions):
        bs = self.block_samples
        needed = sorted({int(p) // bs for p in positions})
        with self._cond:
            self._ensure_producer(needed[0])
            self._demand_block = max(self._demand_block, needed[-1])
            self._cond.notify_all()
            while True:
                if self._producer_stop:
                    raise RuntimeError("%s stopped while a window was "
                                       "being materialized" % self.name)
                if all(b in self._blocks for b in needed):
                    break
                self._cond.wait(1.0)
                self._ensure_producer(needed[0])
            grabbed = {b: self._blocks[b] for b in needed}
            self._advance_floor(int(positions.min()),
                                int(positions.max()) + 1)
            floor_block = self._served_floor // bs
            for b in [b for b in self._blocks if b < floor_block]:
                del self._blocks[b]
            self._tele_buffer.get().set(len(self._blocks))
            self._cond.notify_all()
        names = next(iter(grabbed.values())).keys()
        return {name: numpy.stack(
            [grabbed[int(p) // bs][name][int(p) % bs] for p in positions])
            for name in names}

    def _advance_floor(self, lo, hi):
        """A window of positions [lo, hi) was grabbed: the floor (below it
        every position is served, and its blocks are evicted) moves over
        every contiguously grabbed window. A window grabbed before the one
        below it waits in ``_grabbed``: evicting up to its top would drop
        blocks the lower window still needs. Called under ``_cond``."""
        if lo > self._served_floor:
            self._grabbed[lo] = max(hi, self._grabbed.get(lo, hi))
            return
        floor = max(self._served_floor, hi)
        while True:
            above = [start for start in self._grabbed if start <= floor]
            if not above:
                break
            for start in above:
                floor = max(floor, self._grabbed.pop(start))
        self._served_floor = floor

    def materialize_samples(self, indices, train):
        indices = numpy.asarray(indices)
        off = self.class_offset(CLASS_TRAIN)
        if len(indices) and int(indices[0]) < off:
            # windows are per class: the whole request is the pinned
            # validation set
            return {name: arr[indices] for name, arr in self._valid.items()}
        return self._gather_stream(indices.astype(numpy.int64) - off)

    def stop(self):
        """Stop and join the producer (a fetch in flight may take up to
        ``STOP_TIMEOUT`` to notice), then the decode pool. A later window
        starts a new producer."""
        with self._cond:
            self._producer_stop = True
            producer = self._producer
            self._cond.notify_all()
        if producer is not None and producer is not threading.current_thread():
            producer.join(self.STOP_TIMEOUT)
            if producer.is_alive():
                logger.warning("%s: ingest producer still in a fetch after "
                               "%.3g s", self.name, self.STOP_TIMEOUT)
        super().stop()

    # -- checkpoint: the stream cursor ----------------------------------

    def get_state(self):
        state = super().get_state()
        state["stream_cursor"] = {
            "cursor_base": int(self.cursor_base or 0),
            "ingest_wall": float(self.last_ingest_wall),
        }
        return state

    def set_state(self, state):
        cursor = state.get("stream_cursor")
        if cursor:
            with self._cond:
                self.cursor_base = int(cursor["cursor_base"])
                self.last_ingest_wall = float(cursor.get("ingest_wall",
                                                         0.0))
                # drop the blocks of the position before the restore; a
                # producer's insert in flight is fenced by the sequence
                self._reset_seq += 1
                self._blocks.clear()
                self._next_block = None
                self._demand_block = -1
                self._served_floor = int(self.cursor_base)
                self._grabbed = {}
                self._cond.notify_all()
        super().set_state(state)

    # -- the master's shards and leases ----------------------------------

    def _job_shard(self, job):
        """The shard of a pending job, from its content (the first
        index), so a persisted and restored queue of plain ``(cls,
        [indices])`` pairs keeps its shards."""
        cls, idx = job
        if cls != CLASS_TRAIN or self.shards <= 1 or not idx:
            return None
        return (int(idx[0]) // self.max_minibatch_size) % self.shards

    def _shard_for(self, slave):
        shard = self._slave_shards.get(slave)
        if shard is None:
            used = set(self._slave_shards.values())
            free = [s for s in range(self.shards) if s not in used]
            shard = free[0] if free \
                else len(self._slave_shards) % self.shards
            self._slave_shards[slave] = shard
            logger.info("%s: stream shard %d/%d -> slave %s", self.name,
                        shard, self.shards, slave)
            telemetry.record_event("stream_shard_assigned",
                                   loader=self.name, slave=str(slave),
                                   shard=shard, shards=self.shards)
        return shard

    def master_start_epoch(self):
        """Queue one round: the pinned validation jobs, then the train
        jobs of the next ``round_samples`` stream positions; the cursor
        moves past them (the queue filled is the round claimed)."""
        mb = self.max_minibatch_size
        for cls in (CLASS_TEST, CLASS_VALID):
            if self.class_lengths[cls] == 0:
                continue
            off = self.class_offset(cls)
            indices = numpy.arange(off, off + self.class_lengths[cls],
                                   dtype=numpy.int32)
            for lo in range(0, len(indices), mb):
                self._pending_jobs.append(
                    (cls, indices[lo:lo + mb].tolist()))
        off = self.class_offset(CLASS_TRAIN)
        start = int(self.cursor_base)
        for lo in range(0, self.round_samples, mb):
            hi = min(lo + mb, self.round_samples)
            self._pending_jobs.append(
                (CLASS_TRAIN, [off + start + j for j in range(lo, hi)]))
        self.cursor_base = start + self.round_samples

    def generate_data_for_slave(self, slave=None):
        """The next job of the slave's shard (an unsharded job of any
        class first), else one of a shard no live slave owns; None when
        only other live slaves' shards are left (the master answers
        ``wait``)."""
        if not self._pending_jobs:
            return None
        shard = self._shard_for(slave)
        assigned = set(self._slave_shards.values())
        pick = steal = None
        for i, job in enumerate(self._pending_jobs):
            s = self._job_shard(job)
            if s is None or s == shard:
                pick = i
                break
            if steal is None and s not in assigned:
                steal = i
        if pick is None:
            pick = steal
        if pick is None:
            return None
        job = self._pending_jobs.pop(pick)
        self._inflight.setdefault(slave, []).append(job)
        return job

    def drop_slave(self, slave=None):
        """Release the slave's shard and requeue its jobs."""
        self._slave_shards.pop(slave, None)
        return super().drop_slave(slave)
