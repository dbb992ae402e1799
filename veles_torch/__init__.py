"""veles_torch — the PyTorch/CUDA port of the znicz-tpu framework.

A second package beside the JAX package ``veles``, which stays the
reference: the same samples, configs and seeds, computed with PyTorch,
with every Pallas kernel of the reference replaced by a hand-written
CUDA kernel for Hopper (``csrc/``, built by ``kernels.py``). It imports
neither ``jax`` nor ``veles``. ``veles_torch/znicz/`` mirrors
``veles/znicz_tpu/``.
"""

__version__ = "0.1.0"
