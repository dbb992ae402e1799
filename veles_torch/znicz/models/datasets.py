"""Dataset acquisition for the port's samples.

Counterpart of ``veles/znicz_tpu/models/datasets.py``: ``load_mnist``
and ``load_cifar10`` read the real files (MNIST's idx files, CIFAR-10's
``cifar-10-batches-bin``) when they are under
``root.common.dirs.datasets`` and otherwise generate the same
deterministic synthetic stand-in as the reference (seeded class
prototypes + noise under the ``"mnist_synth"`` / ``"cifar_synth"``
generator), bit for bit at the same seed.
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


def load_cifar10():
    """(train_x, train_y, test_x, test_y), x in CHW float [0,1]; the real
    binary batches if on disk, else the synthetic stand-in (5000/1000
    images, drawn in the reference's order)."""
    d = os.path.join(root.common.dirs.datasets, "cifar-10-batches-bin")
    if os.path.isdir(d):
        try:
            xs, ys = zip(*(_read_cifar_bin(
                os.path.join(d, "data_batch_%d.bin" % i))
                for i in range(1, 6)))
            vx, vy = _read_cifar_bin(os.path.join(d, "test_batch.bin"))
        except (OSError, ValueError) as exc:
            logger.warning("dataset cifar10: %s failed validation (%s); "
                           "using the synthetic stand-in", d, exc)
        else:
            logger.warning("dataset cifar10: REAL dir=%s", d)
            return numpy.concatenate(xs), numpy.concatenate(ys), vx, vy
    logger.warning("dataset cifar10: SYNTHETIC")
    return synthetic_images(n_train=5000, n_valid=1000, shape=(32, 32),
                            channels=3, n_classes=10, key="cifar_synth")


def _read_cifar_bin(path):
    """(images (N, 3, 32, 32) float [0,1], labels (N,) int32) of one
    CIFAR-10 binary batch of 3073-byte records."""
    raw = numpy.fromfile(path, dtype=numpy.uint8)
    if raw.size == 0 or raw.size % 3073:
        raise ValueError("%s: size %d is not a multiple of the "
                         "3073-byte CIFAR record" % (path, raw.size))
    raw = raw.reshape(-1, 3073)
    labels = raw[:, 0].astype(numpy.int32)
    if labels.max() > 9:
        raise ValueError("%s: label %d out of range"
                         % (path, int(labels.max())))
    images = raw[:, 1:].reshape(-1, 3, 32, 32).astype(numpy.float32) / 255.
    return images, labels
