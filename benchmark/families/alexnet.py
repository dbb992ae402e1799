"""The AlexNet family: the program's ``imagenet`` workflow on its bank path.

Maps a configuration and a traffic mix onto the ``root.imagenet`` keys
that ``python -m veles_torch veles_torch/znicz/models/imagenet.py``
reads, hands the program the image bank, the parameters and the dropout
generators' seeds the benchmark made, names the program's parameters by
the reference's leaves, and gives the reference the same minibatches.
"""

import os

import numpy
import torch

import inputs
import yardstick
from reference import alexnet as ref

MODEL_MODULE = "veles_torch.znicz.models.imagenet"
MODEL_FILE = "veles_torch/znicz/models/imagenet.py"
RATE = "train_images_per_s"
UNIT = "images/s"
#: images made a call while the bank is drawn
BANK_CHUNK = 512


def units_per_sample(traffic):
    return 1


def step_flops(config, traffic):
    return yardstick.alexnet_step_flops(config["model"], traffic)


def configure(root, config, traffic):
    """``root.imagenet`` for this configuration and traffic: the bank
    path (a ``base_dir`` that holds no tree), the decision never ends the
    run."""
    m = config["model"]
    root.update(config.get("root", {}))
    root.imagenet.update({
        "loader": {"minibatch_size": int(traffic["minibatch_size"]),
                   "base_dir": os.path.join(os.path.dirname(__file__),
                                            "no-image-tree"),
                   "scale": tuple(m["scale"]), "crop": tuple(m["crop"]),
                   "n_classes": int(m["num_classes"]),
                   "n_train": int(traffic["n_train"]),
                   "n_valid": int(traffic["n_valid"])},
        "decision": {"max_epochs": 10 ** 9, "fail_iterations": 10 ** 9},
    })


def make_data(config, traffic, seed, device):
    """{"data": uint8 (N, H, W, 3), "labels": int64 (N,)}: each image its
    class's 8×8 prototype, upscaled, plus noise drawn at a quarter of the
    resolution and tiled, clipped to bytes; classes uniform."""
    m = config["model"]
    h, w = m["scale"]
    n = int(traffic["n_train"]) + int(traffic["n_valid"])
    gen = inputs.generator(seed, device)
    labels = torch.randint(0, int(m["num_classes"]), (n,), generator=gen,
                           device=device)
    small = torch.rand((int(m["num_classes"]), 8, 8, 3), generator=gen,
                       device=device) * 255.0
    bank = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, BANK_CHUNK):
        hi = min(lo + BANK_CHUNK, n)
        base = torch.nn.functional.interpolate(
            small[labels[lo:hi]].permute(0, 3, 1, 2), size=(h, w),
            mode="nearest")
        noise = torch.randint(-48, 48, (hi - lo, 3, h // 4, w // 4),
                              generator=gen, device=device)
        noise = noise.repeat(1, 1, 4, 4)[:, :, :h, :w]
        bank[lo:hi] = (base + noise).clamp_(0, 255).to(torch.uint8) \
            .permute(0, 2, 3, 1)
    return {"data": bank, "labels": labels}


def make_inputs(config, traffic, seed, device):
    sd = inputs.seeds(seed)
    params = inputs.make_params(ref.leaves(config["model"]), sd["params"],
                                device)
    return params, make_data(config, traffic, sd["data"], device), sd


def attach(wf, data, traffic):
    """The loader serves ``data`` (on the device) in place of its own
    synthetic bank."""
    loader = wf.loader
    n_valid, n_train = int(traffic["n_valid"]), int(traffic["n_train"])

    def load_data():
        n = n_valid + n_train
        shape = tuple(data["data"].shape[1:])
        loader.original_data = numpy.broadcast_to(
            numpy.zeros((1,) + shape, numpy.uint8), (n,) + shape)
        loader.original_labels = numpy.broadcast_to(
            numpy.zeros(1, numpy.int32), (n,))
        loader.class_lengths = [0, n_valid, n_train]

    loader.load_data = load_data
    loader.device_full_arrays = lambda device: data
    return wf


def _units(wf, prefix):
    return [(i, f) for i, f in enumerate(wf.forwards)
            if (type(f).MAPPING or "").startswith(prefix)]


def program_leaves(wf, config):
    """[(leaf name, forward unit, parameter name, GD unit)] in the
    reference's order, each checked against the reference's shape."""
    m = config["model"]
    convs = _units(wf, "conv")
    fcs = _units(wf, "all2all") + _units(wf, "softmax")
    fcs.sort()
    if len(convs) != len(m["convs"]) or len(fcs) != len(m["fc"]) + 1:
        raise ValueError("the program's AlexNet is not the configured one")
    by_name = {}
    for j, (i, _) in enumerate(convs):
        by_name["conv%d" % (j + 1)] = i
    for j, (i, _) in enumerate(fcs):
        by_name["fc%d" % (len(convs) + 1 + j)] = i
    out = []
    for name, shape, _, _, _ in ref.leaves(m):
        unit, part = name.split(".")
        i = by_name[unit]
        attr = "weights" if part == "w" else "bias"
        t = getattr(wf.forwards[i], attr)
        if t is None or tuple(t.shape) != tuple(shape):
            raise ValueError("%s: shape %s, the reference's %s" % (
                name, None if t is None else tuple(t.shape), shape))
        out.append((name, wf.forwards[i], attr, wf.gds[i]))
    return out


def _dropouts(wf):
    return [f for _, f in _units(wf, "dropout")]


def install(wf, params, sd, config):
    """Hand the program the benchmark's parameters (a copy each), its
    shuffle seed and its dropout generators' seeds; check the program's
    solver settings against the configuration's. -> the leaves."""
    leaves = program_leaves(wf, config)
    t = config["train"]
    for name, unit, attr, gd in leaves:
        setattr(unit, attr, params[name].clone())
        want = (t["learning_rate"], t["gradient_moment"],
                t["weights_decay"])
        have = (gd.learning_rate, gd.gradient_moment, gd.weights_decay)
        if not numpy.allclose(want, have) or gd.weights_decay_bias:
            raise ValueError("%s: solver %s, the configuration's %s"
                             % (gd.name, have, want))
    drops = _dropouts(wf)
    if len(drops) != len(config["model"]["fc"]):
        raise ValueError("%d dropout units, %d configured"
                         % (len(drops), len(config["model"]["fc"])))
    for j, unit in enumerate(drops):
        unit.generator.manual_seed(sd["unit%d" % j])
    wf.loader.prng.seed(sd["shuffle"])
    return leaves


def hyper(config):
    t = config["train"]
    lr, mo = float(t["learning_rate"]), float(t["gradient_moment"])
    l2 = float(t["weights_decay"])
    return {name: (lr, mo, 0.0 if kind == "b" else l2)
            for name, _, kind, _, _ in ref.leaves(config["model"])}


def unit_states(wf):
    """The dropout generators' states, in the units' order."""
    return [unit.generator.get_state() for unit in _dropouts(wf)]


def reference_batches(data, rows, device, config, sd, states=None):
    """The train minibatches of ``rows`` as the reference takes them, with
    the dropout generators seeded as the program's were, or in the
    program's ``states``."""
    m = config["model"]
    gens = [inputs.generator(sd["unit%d" % j], device)
            for j in range(len(m["fc"]))]
    for gen, state in zip(gens, states or ()):
        gen.set_state(state)
    out = []
    for idx in rows:
        i = torch.as_tensor(numpy.asarray(idx, numpy.int64), device=device)
        out.append((ref.batch_images(data["data"], i, m, train=True),
                    data["labels"][i], gens))
    return out


def reference_loss(config, prec, half=False):
    """The reference's loss of a minibatch; ``half`` (a fault planted for
    the check) takes the mean over its first half of rows, the dropout
    draws keeping the full minibatch's shape as the program's do."""
    m = config["model"]
    if not half:
        return lambda params, batch: ref.loss(params, batch, m, prec)

    def loss(params, batch):
        rows = ref.loss_rows(params, batch, m, prec)
        return rows[:rows.shape[0] // 2].mean()
    return loss
