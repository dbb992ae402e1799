"""Seeded deterministic PRNG registry of the PyTorch port.

Counterpart of ``veles/prng.py`` with the same semantics: named
``numpy.random.Generator`` (PCG64) instances whose seeds derive from the
key name, re-seeded from one master seed by :func:`seed_all`. The same
master seed therefore gives the JAX package's numpy draws bit for bit
(weight init, train shuffles, synthetic data).

Randomness inside a step on the device comes from a ``torch.Generator``
seeded from the same named seed (:func:`torch_generator`); its numbers
differ from ``jax.random``'s, so device-side randomness matches the
reference only statistically.
"""

import hashlib

import numpy
import torch

_generators = {}
_master_seed = None


class RandomGenerator:
    """A named, seedable wrapper over ``numpy.random.Generator``."""

    def __init__(self, key: str, seed=None):
        self.key = key
        self.seed(seed if seed is not None else self._default_seed(key))

    @staticmethod
    def _default_seed(key: str) -> int:
        # stable across processes (unlike hash())
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:4], "little")

    def seed(self, seed) -> None:
        self._seed = int(seed)
        self._gen = numpy.random.Generator(numpy.random.PCG64(self._seed))

    @property
    def state_seed(self) -> int:
        return self._seed

    def fill_uniform(self, arr: numpy.ndarray, vmin=-1.0, vmax=1.0):
        arr[...] = self._gen.uniform(vmin, vmax, size=arr.shape) \
            .astype(arr.dtype)

    def fill_normal(self, arr: numpy.ndarray, mean=0.0, stddev=1.0):
        arr[...] = self._gen.normal(mean, stddev, size=arr.shape) \
            .astype(arr.dtype)

    def normal(self, mean, stddev, shape, dtype=numpy.float32):
        return self._gen.normal(mean, stddev, size=shape).astype(dtype)

    def permutation(self, n: int) -> numpy.ndarray:
        return self._gen.permutation(n)

    def randint(self, low, high=None, size=None):
        return self._gen.integers(low, high, size=size)


def get(key: str = "default") -> RandomGenerator:
    """The generator registered under ``key`` (created on first use)."""
    gen = _generators.get(key)
    if gen is None:
        seed = None if _master_seed is None \
            else _key_seed(_master_seed, key)
        gen = _generators[key] = RandomGenerator(key, seed)
    return gen


def torch_generator(key: str, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the named seed
    ``key`` (the bridge for randomness drawn on the device)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(get(key).state_seed)
    return gen


def _key_seed(master: int, key: str) -> int:
    return (master * 1000003 + RandomGenerator._default_seed(key)) \
        % (2 ** 63)


def seed_all(seed: int) -> None:
    """Re-seed every registered generator from one master seed (the
    CLI's ``--seed``). Per-key seeds derive from the key name, so results
    do not depend on registration order."""
    global _master_seed
    _master_seed = int(seed)
    for key, gen in _generators.items():
        gen.seed(_key_seed(_master_seed, key))
