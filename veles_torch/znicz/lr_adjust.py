"""Learning-rate schedules of the PyTorch port.

Counterpart of ``veles/znicz_tpu/lr_adjust.py`` (the port's own copy):
each policy is a pure function ``policy(lr, t) -> lr(t)`` of a base rate
``lr`` (a Python float holding an f32 value) and the GD unit's ``iteration``
counter ``t``, an int32 tensor on the unit's device. The result is an f32
tensor on that device, computed there with no host sync (no ``.item()``,
no ``int(t)``), so a captured step can replay it. The arithmetic is the
reference's traced f32 arithmetic: ``(t // step)`` cast to f32, the
arbitrary schedule a right-sided search, the warmup ``(t+1)/warmup``.

Policies are given as objects or config dicts (``{"name": "step",
"gamma": 0.1, "step": 1000}``), also inside a layer's ``"<-"`` kwargs.
"""

import math

import numpy
import torch


class LRPolicy:
    """Base: an lr schedule evaluated on the device."""

    def __call__(self, lr, t):
        raise NotImplementedError

    def __repr__(self):
        args = ", ".join("%s=%r" % kv for kv in sorted(vars(self).items())
                         if not kv[0].startswith("_"))
        return "%s(%s)" % (type(self).__name__, args)


class FixedPolicy(LRPolicy):
    """lr(t) = base."""

    def __call__(self, lr, t):
        return torch.full((), lr, dtype=torch.float32, device=t.device)


class StepPolicy(LRPolicy):
    """lr(t) = base · gamma ** floor(t / step)  (Caffe "step")."""

    def __init__(self, gamma=0.1, step=1000):
        self.gamma = float(gamma)
        self.step = int(step)

    def __call__(self, lr, t):
        k = torch.div(t, self.step, rounding_mode="floor").float()
        return lr * torch.pow(self.gamma, k)


class ExpPolicy(LRPolicy):
    """lr(t) = base · gamma ** t  (Caffe "exp")."""

    def __init__(self, gamma=0.999):
        self.gamma = float(gamma)

    def __call__(self, lr, t):
        return lr * torch.pow(self.gamma, t.float())


class InvPolicy(LRPolicy):
    """lr(t) = base · (1 + gamma·t) ** -power  (Caffe "inv")."""

    def __init__(self, gamma=0.0001, power=0.75):
        self.gamma = float(gamma)
        self.power = float(power)

    def __call__(self, lr, t):
        return lr * torch.pow(1.0 + self.gamma * t.float(), -self.power)


class ArbitraryStepPolicy(LRPolicy):
    """``[(lr0, n0), (lr1, n1), ...]``: ``lr_i`` for ``n_i`` iterations,
    the last value kept after. Replaces the base lr."""

    def __init__(self, schedule):
        if not schedule:
            raise ValueError("empty schedule")
        self.schedule = [(float(v), int(n)) for v, n in schedule]
        self._bounds = numpy.cumsum(
            [n for _, n in self.schedule[:-1]]).astype(numpy.int32)
        self._values = numpy.asarray([v for v, _ in self.schedule],
                                     numpy.float32)
        self._on = {}

    def _tables(self, device):
        """(bounds, values) on ``device``, uploaded once."""
        tables = self._on.get(device)
        if tables is None:
            tables = (torch.from_numpy(self._bounds).to(device),
                      torch.from_numpy(self._values).to(device))
            self._on[device] = tables
        return tables

    def __call__(self, lr, t):
        bounds, values = self._tables(t.device)
        idx = torch.searchsorted(bounds, t.reshape(1), right=True)
        return values[idx].reshape(())


class WarmupCosinePolicy(LRPolicy):
    """Linear warmup over ``warmup`` iterations, ``(t+1)/warmup``, then a
    cosine decay to ``min_ratio``·base over the remaining ``total -
    warmup``."""

    def __init__(self, warmup=100, total=10000, min_ratio=0.0):
        if total <= warmup:
            raise ValueError("total must exceed warmup")
        self.warmup = int(warmup)
        self.total = int(total)
        self.min_ratio = float(min_ratio)

    def __call__(self, lr, t):
        tf = t.float()
        warm = (tf + 1.0) / max(self.warmup, 1)
        frac = torch.clamp((tf - self.warmup) / (self.total - self.warmup),
                           0.0, 1.0)
        cos = self.min_ratio + (1.0 - self.min_ratio) * 0.5 \
            * (1.0 + torch.cos(float(numpy.float32(math.pi)) * frac))
        return lr * torch.where(tf < self.warmup, warm, cos)


POLICIES = {
    "fixed": FixedPolicy,
    "step": StepPolicy,
    "exp": ExpPolicy,
    "inv": InvPolicy,
    "arbitrary_step": ArbitraryStepPolicy,
    "warmup_cosine": WarmupCosinePolicy,
}


def make_policy(spec):
    """None | LRPolicy | callable | {"name": ..., **kwargs} -> policy."""
    if spec is None or isinstance(spec, LRPolicy) or callable(spec):
        return spec
    if isinstance(spec, dict):
        spec = dict(spec)
        name = spec.pop("name")
        return POLICIES[name](**spec)
    raise TypeError("cannot build an lr policy from %r" % (spec,))
