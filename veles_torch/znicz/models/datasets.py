"""Dataset acquisition for the port's samples.

Counterpart of ``veles/znicz_tpu/models/datasets.py``: ``load_mnist``
reads the real idx files when they are under
``root.common.dirs.datasets`` and otherwise generates the same
deterministic synthetic stand-in as the reference (seeded class
prototypes + noise under the ``"mnist_synth"`` generator), bit for bit
at the same seed.
"""

import gzip
import logging
import os
import struct

import numpy

from veles_torch import prng
from veles_torch.config import root

logger = logging.getLogger("veles_torch.datasets")


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">i", f.read(4))
        ndim = magic & 0xFF
        if (magic >> 16) or (magic >> 8) & 0xFF != 0x08:
            raise ValueError("%s: not a ubyte idx file (magic 0x%08x)"
                             % (path, magic))
        shape = struct.unpack(">" + "i" * ndim, f.read(4 * ndim))
        data = numpy.frombuffer(f.read(), dtype=numpy.uint8)
    if data.size != int(numpy.prod(shape, dtype=numpy.int64)):
        raise ValueError("%s: idx payload %d != header %s"
                         % (path, data.size, shape))
    return data.reshape(shape)


def _find_mnist_dir():
    for d in (os.path.join(root.common.dirs.datasets, "MNIST"),
              root.common.dirs.datasets):
        for suffix in ("", ".gz"):
            if os.path.exists(os.path.join(
                    d, "train-images-idx3-ubyte" + suffix)):
                return d
    return None


def _read_mnist(d):
    def rd(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(d, stem + suffix)
            if os.path.exists(p):
                return _read_idx(p)
        raise FileNotFoundError(stem)
    tx = rd("train-images-idx3-ubyte").astype(numpy.float32) / 255.0
    ty = rd("train-labels-idx1-ubyte").astype(numpy.int32)
    vx = rd("t10k-images-idx3-ubyte").astype(numpy.float32) / 255.0
    vy = rd("t10k-labels-idx1-ubyte").astype(numpy.int32)
    if tx.ndim != 3 or len(tx) != len(ty) or len(vx) != len(vy) \
            or ty.max() > 9 or vy.max() > 9:
        raise ValueError("inconsistent idx structure")
    return tx, ty, vx, vy


def load_mnist(n_train=6000, n_valid=1000):
    """(train_x, train_y, test_x, test_y), floats in [0,1]; real data if
    on disk, synthetic otherwise. Sizes cap both sources."""
    d = _find_mnist_dir()
    if d is not None:
        try:
            tx, ty, vx, vy = _read_mnist(d)
        except (ValueError, FileNotFoundError) as exc:
            logger.warning("dataset mnist: %s failed validation (%s); "
                           "using the synthetic stand-in", d, exc)
        else:
            logger.warning("dataset mnist: REAL dir=%s", d)
            return tx[:n_train], ty[:n_train], vx[:n_valid], vy[:n_valid]
    logger.warning("dataset mnist: SYNTHETIC")
    return synthetic_images(n_train=n_train, n_valid=n_valid,
                            shape=(28, 28), n_classes=10, key="mnist_synth")


def synthetic_images(n_train, n_valid, shape, n_classes, key,
                     channels=None, noise=0.35):
    """Class-prototype images + Gaussian noise, deterministic per key
    (the reference's draws, in the reference's order)."""
    gen = prng.get(key)
    full_shape = shape if channels is None else (channels,) + shape
    protos = numpy.stack([
        _smooth(gen.normal(0.0, 1.0, full_shape, numpy.float32))
        for _ in range(n_classes)])

    def make(n):
        labels = gen.randint(0, n_classes, n).astype(numpy.int32)
        x = protos[labels] + gen.normal(
            0.0, noise, (n,) + protos.shape[1:], numpy.float32)
        x = (x - x.min()) / max(x.max() - x.min(), 1e-6)
        return x.astype(numpy.float32), labels

    tx, ty = make(n_train)
    vx, vy = make(n_valid)
    return tx, ty, vx, vy


def _smooth(img):
    """Separable box blur x2 along the trailing two axes."""
    for axis in (-2, -1):
        for _ in range(2):
            img = (numpy.roll(img, 1, axis) + img
                   + numpy.roll(img, -1, axis)) / 3.0
    return img
