"""veles_torch.serving — batched online inference of the PyTorch port.

Counterpart of ``veles/serving``: the archive a workflow exports
(``veles_torch/export_inference.py``, the reference's format) is loaded
and served on a device (``cuda`` unless ``cpu`` is asked for):

* :mod:`veles_torch.serving.model`   — archive loader and forward
  interpreter over the port's training formulas (``ArchiveModel``);
* :mod:`veles_torch.serving.engine`  — the bucketed forward executor
  (``InferenceEngine``);
* :mod:`veles_torch.serving.batcher` — dynamic micro-batching with
  deadlines and shedding (``MicroBatcher``);
* :mod:`veles_torch.serving.decode`  — the generative plane: KV pool,
  prefill per prompt bucket, one shared decode step, continuous
  batching (``GenerativeEngine``, ``ContinuousBatcher``);
* :mod:`veles_torch.serving.quant`   — int8/fp8 weights at rest;
* :mod:`veles_torch.serving.tenants` — tenant identity, quotas and the
  batchers' fair-share weights;
* :mod:`veles_torch.serving.registry` — named models, versions, hot
  reload, checkpoint refresh (``ModelRegistry``);
* :mod:`veles_torch.serving.frontend` — the HTTP frontend and ``python -m
  veles_torch serve`` (``ServingFrontend``, ``serve_main``).
"""

from veles_torch.serving.batcher import (     # noqa: F401
    DeadlineExceeded, MicroBatcher, QueueFull)
from veles_torch.serving.decode import (      # noqa: F401
    ContinuousBatcher, DecodePlan, GenerativeEngine, KVPool)
from veles_torch.serving.engine import InferenceEngine  # noqa: F401
from veles_torch.serving.model import ArchiveModel      # noqa: F401
from veles_torch.serving.registry import (    # noqa: F401
    ModelRegistry, ServedModel)
