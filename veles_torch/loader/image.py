"""Image loaders of the PyTorch port: a directory tree or file lists,
decoded and augmented on the host, shipped as uint8.

Counterpart of ``veles/loader/image.py``: scale to a target size, a
random crop and a p = 0.5 horizontal mirror for a train sample (a centre
crop and no mirror for an evaluation one), RGB or grey, the label from
the class directory. Decoding is ``codecs.py`` (Pillow's pixels, without
Pillow: PNG, JPEG, GIF, BMP and PNM), with its native routines on the
card and their Python twins on the CPU. Each minibatch of a window is one future of the loader's decode
pool (``StreamLoader.materialize_window``); the images travel to the
device as uint8 and :meth:`ImageLoaderBase.batch_transform` maps them to
``(x / 255 − mean) / std`` in float32 there.

Augmentation draws are stateless, the reference's bit for bit: three
uniforms of a numpy PCG64 seeded with ``aug_seed ^ index·0x9E3779B1 ^
epoch·0x85EBCA6B``, where ``aug_seed`` is the ``image_augment``
generator's seed, so the pool's scheduling never changes them and they
do not touch the shuffle's stream.
"""

import os

import numpy
import torch

from veles_torch import prng
from veles_torch.loader import codecs
from veles_torch.loader.stream import StreamLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".gif")


class ImageLoaderBase(StreamLoader):
    """Streams decoded, augmented images.

    * ``scale`` — (h, w) every decoded image is resized to before the
      crop.
    * ``crop`` — (h, w) window cut from the scaled image: at a random
      position for a train sample, centred for an evaluation one.
    * ``mirror`` — ``"random"`` flips a train sample with p = 0.5;
      ``False`` never flips.
    * ``color_space`` — ``"RGB"`` or ``"GRAY"``.
    * ``normalize_mean`` / ``normalize_std`` — the device's float32
      normalization of the pixels scaled to [0, 1].
    """

    def __init__(self, workflow=None, scale=None, crop=None, mirror=False,
                 color_space="RGB", normalize_mean=0.5, normalize_std=0.5,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.scale = tuple(scale) if scale else None
        self.crop = tuple(crop) if crop else None
        if mirror not in (False, "random"):
            raise ValueError("mirror must be False or 'random'")
        self.mirror = mirror
        self.color_space = color_space
        self.normalize_mean = float(normalize_mean)
        self.normalize_std = float(normalize_std)
        self.aug_seed = prng.get("image_augment").state_seed

    # -- subclass surface ---------------------------------------------

    def decode_image(self, index):
        """uint8 (H, W, C) of GLOBAL sample ``index``, before the
        augmentation."""
        raise NotImplementedError

    def label_of(self, index):
        raise NotImplementedError

    # -- geometry ------------------------------------------------------

    @property
    def channels(self):
        return 1 if self.color_space == "GRAY" else 3

    def sample_shape(self):
        if self.crop:
            return self.crop + (self.channels,)
        if self.scale:
            return self.scale + (self.channels,)
        raise ValueError("%s needs scale= or crop= for a static sample "
                         "shape" % self.name)

    def sample_spec(self):
        return {"data": (self.sample_shape(), numpy.uint8),
                "labels": ((), numpy.int32)}

    # -- decode and augment ----------------------------------------------

    @property
    def native_decode(self):
        """The run's decode routines: the native ones
        (``csrc/image_decode.cu``) when its workflow computes on the card,
        their Python twins on the CPU or with no workflow device."""
        device = getattr(getattr(self.workflow, "device", None), "device",
                         None)
        return device is not None and device.type == "cuda"

    def _decode_file(self, path):
        return codecs.load(path, self.color_space, self.scale,
                           native=self.native_decode)

    def _aug_draws(self, index):
        """3 uniforms in [0, 1) (crop y, crop x, mirror), pure in
        (aug_seed, sample index, epoch)."""
        gen = numpy.random.Generator(numpy.random.PCG64(
            (self.aug_seed ^ (int(index) * 0x9E3779B1)
             ^ (self.epoch_number * 0x85EBCA6B)) & 0xFFFFFFFFFFFFFFFF))
        return gen.random(3)

    def _augment(self, arr, train, draws):
        ch, cw = self.crop if self.crop else arr.shape[:2]
        h, w = arr.shape[:2]
        if (h, w) != (ch, cw):
            if train:
                y = int(draws[0] * (h - ch + 1))
                x = int(draws[1] * (w - cw + 1))
            else:
                y, x = (h - ch) // 2, (w - cw) // 2
            arr = arr[y:y + ch, x:x + cw]
        if train and self.mirror == "random" and draws[2] < 0.5:
            arr = arr[:, ::-1]
        return arr

    def materialize_samples(self, indices, train):
        shape = self.sample_shape()
        data = numpy.empty((len(indices),) + shape, numpy.uint8)
        labels = numpy.empty(len(indices), numpy.int32)
        for i, idx in enumerate(numpy.asarray(indices)):
            draws = self._aug_draws(idx) if train else None
            arr = self._augment(self.decode_image(int(idx)), train, draws)
            if arr.shape != shape:
                raise ValueError("%s: decoded %r, expected %r (set scale=)"
                                 % (self.name, arr.shape, shape))
            data[i] = arr
            labels[i] = self.label_of(int(idx))
        return {"data": data, "labels": labels}

    def batch_transform(self, data, train):
        """uint8 (mb, h, w, C) on the device -> float32 ``(x / 255 −
        mean) / std``."""
        std = max(self.normalize_std, 1e-6)
        return (data.to(torch.float32) / 255.0 - self.normalize_mean) / std


class FileImageLoader(ImageLoaderBase):
    """Explicit path lists per class (``test_paths``, ``valid_paths``,
    ``train_paths``) with parallel label lists, or labels from the parent
    directory's name (sorted)."""

    def __init__(self, workflow=None, train_paths=(), valid_paths=(),
                 test_paths=(), train_labels=None, valid_labels=None,
                 test_labels=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self._paths = list(test_paths) + list(valid_paths) \
            + list(train_paths)
        self._class_sizes = [len(test_paths), len(valid_paths),
                             len(train_paths)]
        self._label_names = None
        labels = []
        for lst, paths in ((test_labels, test_paths),
                           (valid_labels, valid_paths),
                           (train_labels, train_paths)):
            if lst is None:
                lst = [self.infer_label(p) for p in paths]
            labels.extend(lst)
        self._labels = numpy.asarray(labels, numpy.int32) \
            if labels else numpy.zeros(0, numpy.int32)

    def infer_label(self, path):
        """The parent directory's index among the sorted directory
        names."""
        return self._dir_label(os.path.basename(os.path.dirname(path)))

    def _dir_label(self, name):
        if self._label_names is None:
            dirs = sorted({os.path.basename(os.path.dirname(p))
                           for p in self._paths})
            self._label_names = {d: i for i, d in enumerate(dirs)}
        return self._label_names[name]

    def load_data(self):
        if not self._paths:
            raise ValueError("%s: no image paths" % self.name)
        self.class_lengths = list(self._class_sizes)

    def decode_image(self, index):
        return self._decode_file(self._paths[index])

    def label_of(self, index):
        return int(self._labels[index])

    @property
    def n_classes(self):
        return int(self._labels.max()) + 1 if len(self._labels) else 0


class AutoLabelFileImageLoader(FileImageLoader):
    """A directory tree ``<base>/<class>/*.<image ext>``: the label is the
    class directory's index in sorted order; every ``round(1 /
    valid_ratio)``-th file of each class (from its first) is held out for
    validation, so one tree always gives one split."""

    def __init__(self, workflow=None, base_dir=None, valid_ratio=0.1,
                 **kwargs):
        paths_by_class = {}
        for entry in sorted(os.listdir(base_dir)):
            sub = os.path.join(base_dir, entry)
            if not os.path.isdir(sub):
                continue
            files = sorted(os.path.join(sub, f) for f in os.listdir(sub)
                           if f.lower().endswith(IMAGE_EXTS))
            if files:
                paths_by_class[entry] = files
        if not paths_by_class:
            raise ValueError("no class directories under %r" % base_dir)
        train, valid = [], []
        stride = max(int(round(1.0 / valid_ratio)), 2) \
            if valid_ratio > 0 else 0
        for files in paths_by_class.values():
            for i, p in enumerate(files):
                (valid if stride and i % stride == 0 else train).append(p)
        super().__init__(workflow, train_paths=train, valid_paths=valid,
                         **kwargs)
