"""Inputs made from the seed, the same for the program and the reference.

A run's seed (any whole number) spreads into independent 32-bit seeds
(``numpy.random.SeedSequence``): the parameters, the data, the loader's
shuffle, and any generator a unit draws from. Parameters and data are
made on the device by ``torch.Generator`` in a few large calls; making
them again from the same seed gives the same tensors, so the reference
remakes them after the program's state is freed.
"""

import numpy
import torch

#: the seeds a run's seed spreads into, by use
SEED_NAMES = ("params", "data", "shuffle", "unit0", "unit1", "unit2",
              "unit3")


def seeds(seed):
    """{use: 32-bit seed} of a run's ``seed`` (any whole number)."""
    words = numpy.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
        len(SEED_NAMES), numpy.uint32)
    return {name: int(w) for name, w in zip(SEED_NAMES, words)}


def generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def make_params(leaves, seed, device):
    """{name: float32 tensor} of ``leaves`` ([(name, shape, kind, fan_in,
    fan_out)]): "w" uniform in ±√3·√(2 / (fan_in + fan_out)) (Glorot's
    scale, the program's default), "b" zeros, "g" ones. The uniforms of
    every matrix come from one draw."""
    gen = generator(seed, device)
    total = sum(int(numpy.prod(s)) for _, s, kind, _, _ in leaves
                if kind == "w")
    u = torch.rand(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, kind, fan_in, fan_out in leaves:
        if kind == "w":
            n = int(numpy.prod(shape))
            bound = float(numpy.sqrt(3.0) * numpy.sqrt(
                2.0 / (fan_in + fan_out)))
            out[name] = ((u[pos:pos + n] * 2.0 - 1.0) * bound).view(shape)
            pos += n
        elif kind == "g":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def train_rows(traffic, shuffle_seed, steps):
    """Dataset rows of the first ``steps`` train minibatches of the first
    epoch: the loader's layout is [valid | train] and it serves the train
    rows in the order of a PCG64 permutation from the shuffle seed the
    benchmark gave it (``numpy.random.Generator.permutation``)."""
    mb = int(traffic["minibatch_size"])
    n_valid, n_train = int(traffic["n_valid"]), int(traffic["n_train"])
    perm = numpy.random.Generator(
        numpy.random.PCG64(shuffle_seed)).permutation(n_train)
    return [n_valid + perm[k * mb:(k + 1) * mb] for k in range(steps)]
