"""Bucketed forward executor of the port's predict plane.

Counterpart of ``veles/serving/engine.py``. A model's parameters go to
the engine's device once, in :meth:`InferenceEngine.set_model` (a hot
swap replaces them); every batch is padded up to the next power-of-two
bucket of the ladder ``1, 2, 4, ... max_batch`` (pad rows repeat the last
real row and are sliced off after), so a few batch shapes serve every
request size. The forward runs eagerly, one per bucket shape; a bucket's
first run ("compile" in the reference, where it traces and compiles a
program) is timed into ``compile_seconds`` and :meth:`warmup` makes it
before traffic, and each first run is a ``serving.compile`` span of the
tracer (``telemetry.py``). A CUDA graph per bucket waits for ROADMAP
Queue 1 item 1.
"""

import threading
import time

import numpy
import torch

from veles_torch import telemetry
from veles_torch.backends import bind_thread, torch_device
from veles_torch.serving.quant import quantize_tree, tree_to, validate_mode


def bucket_sizes(max_batch):
    """The power-of-two bucket ladder: 1, 2, 4, ... max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return out


class InferenceEngine:
    """Forward executor for ONE :class:`ArchiveModel` on ``device``
    (``cuda`` unless ``cpu`` is asked for). ``quantize`` (``none``,
    ``int8``, ``fp8``) holds the weights at rest quantized."""

    def __init__(self, model, max_batch=64, quantize="none",
                 device="cuda"):
        validate_mode(quantize)
        self.quantize = quantize
        self.max_batch = int(max_batch)
        self.device = torch_device(device)
        self._lock = threading.Lock()
        self._warm = set()             # batch shapes run at least once
        self.compile_seconds = {}      # bucket -> first run's seconds
        self._model = None
        self._device_params = None
        self.set_model(model)

    # -- model swap (hot reload) ---------------------------------------

    def set_model(self, model, params_only=False):
        """Swap the served model. ``params_only=True`` (same architecture:
        the caller checked ``signature()``) keeps the warm buckets; with a
        quantize mode the model's params are re-quantized in place (a
        leaf already in that mode passes through)."""
        with self._lock:
            self._model = model
            if not params_only:
                self._warm.clear()
                self.compile_seconds = {}
            if self.quantize != "none":
                model.params = quantize_tree(model.params, self.quantize)
            self._device_params = tree_to(model.params, self.device)

    @property
    def model(self):
        return self._model

    @property
    def params(self):
        """The device copy of the served parameters."""
        return self._device_params

    # -- bucket math ---------------------------------------------------

    def bucket_for(self, n):
        """Smallest power-of-two bucket >= n (capped at max_batch)."""
        if n > self.max_batch:
            raise ValueError("batch %d exceeds max_batch %d"
                             % (n, self.max_batch))
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.max_batch)

    def warmup(self, buckets=None):
        """Run every bucket of the ladder once on zeros so that first
        requests find them warm; -> {bucket: seconds}."""
        if self._model.input_sample_shape is None:
            return {}
        for b in buckets or bucket_sizes(self.max_batch):
            self._run(torch.zeros((int(b),)
                                  + self._model.input_sample_shape,
                                  dtype=torch.float32, device=self.device))
        return dict(self.compile_seconds)

    @property
    def compiled_buckets(self):
        with self._lock:
            return sorted(shape[0] for shape in self._warm)

    # -- execution -----------------------------------------------------

    def _run(self, x):
        shape = tuple(x.shape)
        first = shape not in self._warm
        t0 = time.perf_counter()
        y = self._model.apply(self._device_params, x)
        if first:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if telemetry.tracer.active:
                telemetry.tracer.add_complete(
                    "serving.compile", t0, dt, bucket=shape[0])
            with self._lock:
                self._warm.add(shape)
                self.compile_seconds[shape[0]] = dt
        return y

    def predict(self, x):
        """The forward of (n, *sample) rows (array or tensor), padded up
        to the bucket and the pad rows sliced off; -> (float32 numpy
        outputs, bucket)."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(numpy.ascontiguousarray(x, numpy.float32))
        n = x.shape[0]
        bucket = self.bucket_for(n)
        bind_thread(self.device)
        x = x.to(self.device, torch.float32)
        if bucket > n:
            x = torch.cat([x, x[-1:].expand((bucket - n,) + x.shape[1:])])
        y = self._run(x)
        return y[:n].cpu().numpy(), bucket
