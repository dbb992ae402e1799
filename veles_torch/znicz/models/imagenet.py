"""ImageNet AlexNet sample of the port.

Counterpart of ``veles/znicz_tpu/models/imagenet.py``: one-tower
AlexNet over NHWC — five conv blocks (softplus "relu", cross-map LRN
after the first two, overlapping 3×3/s2 max pools), two dropout +
FC(4096) blocks and a softmax classifier — with the same
``root.imagenet`` defaults (minibatch 128, 256×256 bank, 227×227 crop).

Data: an image tree under ``root.imagenet.loader.base_dir`` (default
``<datasets>/ImageNet``; ``<base>/<class>/*.<ext>``, as
``imagenet_prep.py`` stages it) streams through
``AutoLabelFileImageLoader`` (``veles_torch/loader/image.py``): decoded
on the host, scaled to ``scale``, randomly cropped to ``crop`` and
mirrored for training (centre crop for validation), shipped as uint8 and
normalized on the device; the softmax width is the tree's class count.
A staged ``*.JPEG`` tree reads as any other (``loader/jpeg.py``); a file
that does not decode raises with its path, and nothing falls back to the
bank. Without a tree: the
reference's deterministic synthetic stand-in, a uint8 bank of per-class
low-frequency prototypes plus per-index noise made with numpy bit for
bit as the reference makes it, resident on the device; each gathered
minibatch is center-cropped, mirrored (every other row, train only) and
normalized on the device (``batch_transform``).

    python -m veles_torch veles_torch/znicz/models/imagenet.py -d cuda
"""

import logging
import os

import numpy
import torch

from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.loader.image import IMAGE_EXTS, AutoLabelFileImageLoader
from veles_torch.znicz.standard_workflow import StandardWorkflow

logger = logging.getLogger("veles_torch.imagenet")


def alexnet_layers(n_classes, lr=0.01, wd=0.0005, moment=0.9):
    gd = {"learning_rate": lr, "weights_decay": wd,
          "gradient_moment": moment}
    return [
        {"type": "conv_relu",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11, "sliding": 4},
         "<-": dict(gd)},
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75,
                                "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": 2}},
        {"type": "conv_relu",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": 2},
         "<-": dict(gd)},
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75,
                                "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": 2}},
        {"type": "conv_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        {"type": "conv_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        {"type": "conv_relu",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": 2}},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 4096},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 4096},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


root.imagenet.update({
    "loader": {"minibatch_size": 128, "base_dir": None,
               "scale": (256, 256), "crop": (227, 227),
               # synthetic stand-in sizing
               "n_classes": 16, "n_train": 2048, "n_valid": 256},
    "decision": {"max_epochs": 10, "fail_iterations": 10},
    "lr": 0.01,
})


class SyntheticImageLoader(FullBatchLoader):
    """The reference's synthetic image corpus as a uint8 bank on the
    device; crop, mirror and normalize run on the device per minibatch
    (:meth:`batch_transform`)."""

    def __init__(self, workflow=None, n_classes=16, n_train=2048,
                 n_valid=256, seed=0xA1E7, scale=(256, 256),
                 crop=(227, 227), normalize_mean=0.5, normalize_std=0.5,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_classes = int(n_classes)
        self._n_train = int(n_train)
        self._n_valid = int(n_valid)
        self._seed = int(seed)
        self.scale = tuple(scale)
        self.crop = tuple(crop)
        self.normalize_mean = float(normalize_mean)
        self.normalize_std = float(normalize_std)
        self.serve_dtype = numpy.uint8   # the bank ships as bytes

    def load_data(self):
        """The reference's draws in the reference's order."""
        self.class_lengths = [0, self._n_valid, self._n_train]
        n = self._n_valid + self._n_train
        gen = numpy.random.Generator(numpy.random.PCG64(self._seed))
        h, w = self.scale
        c = 3
        small = gen.uniform(0, 255, (self.n_classes, 8, 8, c))
        reps = (h + 7) // 8, (w + 7) // 8
        protos = numpy.kron(
            small, numpy.ones((1, reps[0], reps[1], 1)))[
            :, :h, :w, :].astype(numpy.int16)
        bank = numpy.empty((n, h, w, c), numpy.uint8)
        th, tw = (h + 3) // 4, (w + 3) // 4
        labels = numpy.arange(n) % self.n_classes
        for lo in range(0, n, 256):       # cap transient int16 memory
            hi = min(lo + 256, n)
            noise = gen.integers(-48, 48, (hi - lo, th, tw, c),
                                 dtype=numpy.int16)
            noise = numpy.tile(noise, (1, 4, 4, 1))[:, :h, :w, :]
            numpy.clip(protos[labels[lo:hi]] + noise, 0, 255, out=noise)
            bank[lo:hi] = noise
        self.original_data = bank
        self.original_labels = labels.astype(numpy.int32)

    def sample_shape(self):
        return tuple(self.crop) + (3,)

    def batch_transform(self, data, train):
        """uint8 (mb, H, W, C) -> float32 (mb, ch, cw, C): center crop,
        mirror every other row (train only: eval sees the true pixels),
        normalize — the reference's ``_augment``."""
        ph, pw = self.scale
        ch, cw = self.crop
        y, x = (ph - ch) // 2, (pw - cw) // 2
        data = data[:, y:y + ch, x:x + cw, :]
        if train:
            even = (torch.arange(data.shape[0], device=data.device)
                    % 2 == 0)[:, None, None, None]
            data = torch.where(even, data.flip(2), data)
        std = max(self.normalize_std, 1e-6)
        return (data.to(torch.float32) / 255.0 - self.normalize_mean) / std


def _real_tree():
    """(base_dir, n_classes) of a usable real image tree, or (None, 0):
    the reference's rule (a subdirectory counts when it holds image
    files; ``*.partial`` staging directories do not)."""
    base = root.imagenet.loader.get("base_dir") or os.path.join(
        root.common.dirs.datasets, "ImageNet")
    if not (base and os.path.isdir(base)):
        return None, 0
    n = 0
    for entry in os.listdir(base):
        if entry.endswith(".partial"):
            continue
        sub = os.path.join(base, entry)
        if os.path.isdir(sub) and any(
                f.lower().endswith(IMAGE_EXTS) for f in os.listdir(sub)):
            n += 1
    return (base, n) if n else (None, 0)


def make_loader(wf):
    cfg = root.imagenet.loader
    base, n = _real_tree()
    if base:
        logger.warning("dataset imagenet: real tree %s (%d classes)",
                       base, n)
        return AutoLabelFileImageLoader(
            wf, name="loader", base_dir=base, scale=tuple(cfg.scale),
            crop=tuple(cfg.crop), mirror="random",
            minibatch_size=cfg.minibatch_size)
    logger.warning("dataset imagenet: SYNTHETIC")
    return SyntheticImageLoader(
        wf, name="loader", minibatch_size=cfg.minibatch_size,
        n_classes=cfg.n_classes, n_train=cfg.n_train, n_valid=cfg.n_valid,
        scale=tuple(cfg.scale), crop=tuple(cfg.crop))


def _probe_classes():
    """Softmax width before the loader exists: a real tree's class count,
    else the configured synthetic one."""
    base, n = _real_tree()
    return n if base else root.imagenet.loader.n_classes


def create_workflow(name="AlexNetWorkflow"):
    cfg = root.imagenet
    return StandardWorkflow(
        name=name, layers=alexnet_layers(_probe_classes(), lr=cfg.lr),
        loader_factory=make_loader, decision_config=cfg.decision.to_dict())
