"""Pluggable input-data normalizers of the PyTorch port.

The port's own copy of ``veles/normalization.py`` (numpy only, no
torch): a registry keyed by config name, so a loader takes
``normalization_type="mean_disp"`` + ``normalization_parameters={...}``
and builds the normalizer through :func:`factory`. The API has two
phases: :meth:`NormalizerBase.analyze` fits statistics on (batches of)
TRAINING data, accumulating across calls, and
:meth:`NormalizerBase.normalize` applies the fitted transform to any
array. :meth:`NormalizerBase.state` / :func:`from_state` round-trip the
fitted statistics. Every fitted transform is affine per feature, so
``mean_rdisp()`` gives it as (mean, 1/disp) arrays: what the on-device
``MeanDispNormalizer`` unit (``znicz/ops/mean_disp_normalizer.py``)
takes. The same names, formulas and state keys as the reference, so a
state written by either package restores in the other.
"""

import numpy

NORMALIZERS = {}


def normalizer(name):
    def deco(cls):
        cls.NAME = name
        NORMALIZERS[name] = cls
        return cls
    return deco


def factory(name, **kwargs):
    """Build a normalizer by config name; ``None``/'none' => no-op."""
    if name is None:
        name = "none"
    try:
        cls = NORMALIZERS[name]
    except KeyError:
        raise KeyError("unknown normalization_type %r (known: %s)"
                       % (name, ", ".join(sorted(NORMALIZERS))))
    return cls(**kwargs)


class NormalizerBase:
    """Streaming-analyze / apply API shared by the family."""

    NAME = None

    def analyze(self, batch):
        """Accumulate statistics from a (N, ...) training batch."""

    def normalize(self, arr):
        """Return the normalized array (float32, same shape)."""
        raise NotImplementedError

    # -- checkpoint round-trip ----------------------------------------

    def state(self):
        # EVERYTHING, including accumulator attributes: a checkpoint
        # between analyze() and the first normalize() must restore the
        # in-flight statistics. Arrays are COPIED — the in-place
        # accumulators must not mutate an already-captured state.
        # __name__ records the registry type so restore can rebuild
        # the right class even into a differently-configured loader.
        out = {k: (v.copy() if isinstance(v, numpy.ndarray) else v)
               for k, v in vars(self).items()}
        out["__name__"] = self.NAME
        return out

    def set_state(self, state):
        for k, v in state.items():
            if k == "__name__":
                continue
            setattr(self, k,
                    v.copy() if isinstance(v, numpy.ndarray) else v)


    # -- device-path export -------------------------------------------

    def mean_rdisp(self, sample_shape):
        """(mean, rdisp) arrays of ``sample_shape`` such that
        normalize(x) == (x - mean) * rdisp — feeds the on-device
        MeanDispNormalizer unit. Subclasses with non-affine transforms
        must override or raise."""
        zero = numpy.zeros(sample_shape, numpy.float32)
        one = numpy.ones(sample_shape, numpy.float32)
        probe0 = self.normalize(zero[None])[0]
        probe1 = self.normalize(one[None])[0]
        rdisp = probe1 - probe0
        return -probe0 / numpy.where(rdisp == 0, 1, rdisp), rdisp


def from_state(state):
    """Rebuild a normalizer purely from its checkpointed state."""
    cls = NORMALIZERS[state["__name__"]]
    n = cls.__new__(cls)
    n.set_state(state)
    return n


@normalizer("none")
class NoneNormalizer(NormalizerBase):
    def normalize(self, arr):
        return numpy.asarray(arr, numpy.float32)


@normalizer("linear")
class LinearNormalizer(NormalizerBase):
    """Affine map of the GLOBAL analyzed [min, max] onto
    [interval[0], interval[1]] (default [-1, 1])."""

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(float(v) for v in interval)
        self.vmin = numpy.inf
        self.vmax = -numpy.inf

    def analyze(self, batch):
        self.vmin = min(self.vmin, float(numpy.min(batch)))
        self.vmax = max(self.vmax, float(numpy.max(batch)))

    def normalize(self, arr):
        lo, hi = self.interval
        span = self.vmax - self.vmin
        if not numpy.isfinite(span) or span == 0:
            raise ValueError("analyze() never saw data")
        x = numpy.asarray(arr, numpy.float32)
        return (x - self.vmin) * ((hi - lo) / span) + lo


@normalizer("range_linear")
class RangeLinearNormalizer(LinearNormalizer):
    """Linear with a FIXED source range (no analyze needed) — e.g.
    uint8 images: source_range=(0, 255)."""

    def __init__(self, source_range=(0.0, 255.0), interval=(-1.0, 1.0)):
        super().__init__(interval)
        self.vmin, self.vmax = (float(v) for v in source_range)

    def analyze(self, batch):
        pass


@normalizer("mean_disp")
class MeanDispNormalizer(NormalizerBase):
    """Per-feature (x - mean) / dispersion, dispersion = half the
    analyzed per-feature value range (matching the reference's
    mean-dispersion scheme); features with zero range pass
    through centered."""

    def __init__(self):
        self.mean = None
        self._sum = None
        self._min = None
        self._max = None
        self._count = 0

    def analyze(self, batch):
        b = numpy.asarray(batch, numpy.float32)
        if self._sum is None:
            self._sum = b.sum(axis=0)
            self._min = b.min(axis=0)
            self._max = b.max(axis=0)
        else:
            self._sum += b.sum(axis=0)
            numpy.minimum(self._min, b.min(axis=0), out=self._min)
            numpy.maximum(self._max, b.max(axis=0), out=self._max)
        self._count += len(b)
        # new data invalidates the fitted transform: re-fit lazily so
        # streaming accumulation keeps the documented semantics
        self.mean = None

    def _fit(self):
        if self._count == 0:
            raise ValueError("analyze() never saw data")
        self.mean = (self._sum / self._count).astype(numpy.float32)
        disp = (self._max - self._min).astype(numpy.float32) / 2.0
        self.rdisp = (1.0 / numpy.where(disp == 0, 1.0, disp)) \
            .astype(numpy.float32)
        return self.mean, self.rdisp

    def normalize(self, arr):
        if self.mean is None:
            self._fit()
        return ((numpy.asarray(arr, numpy.float32) - self.mean)
                * self.rdisp)

    def mean_rdisp(self, sample_shape):
        if self.mean is None:
            self._fit()
        return self.mean, self.rdisp


@normalizer("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature affine map of the analyzed [min, max] onto [-1, 1]
    (each pixel/feature scaled independently — the reference's
    pointwise scheme)."""

    def __init__(self):
        self._min = None
        self._max = None

    def analyze(self, batch):
        b = numpy.asarray(batch, numpy.float32)
        if self._min is None:
            self._min = b.min(axis=0)
            self._max = b.max(axis=0)
        else:
            numpy.minimum(self._min, b.min(axis=0), out=self._min)
            numpy.maximum(self._max, b.max(axis=0), out=self._max)

    def normalize(self, arr):
        if self._min is None:
            raise ValueError("analyze() never saw data")
        span = self._max - self._min
        scale = (2.0 / numpy.where(span == 0, 1.0, span)) \
            .astype(numpy.float32)
        x = numpy.asarray(arr, numpy.float32)
        return numpy.where(span == 0, 0.0,
                           (x - self._min) * scale - 1.0)


@normalizer("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract an externally-supplied mean array (e.g. the ImageNet
    pixel mean shipped with a dataset); optional scale."""

    def __init__(self, mean=None, scale=1.0):
        if mean is None:
            raise ValueError("external_mean needs mean=")
        self.mean = numpy.asarray(mean, numpy.float32)
        self.scale = float(scale)

    def normalize(self, arr):
        return ((numpy.asarray(arr, numpy.float32) - self.mean)
                * self.scale)
