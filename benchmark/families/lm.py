"""The language-model family: the program's ``transformer_lm`` workflow.

Maps a configuration's published sizes and a traffic mix onto the
``root.lm`` keys that ``python -m veles_torch
veles_torch/znicz/models/transformer_lm.py`` reads, hands the program
the token corpus and the parameters the benchmark made, names the
program's parameters by the reference's leaves, and gives the reference
the same minibatches.
"""

import numpy
import torch

import inputs
import yardstick
from reference import lm as ref

MODEL_MODULE = "veles_torch.znicz.models.transformer_lm"
MODEL_FILE = "veles_torch/znicz/models/transformer_lm.py"
#: the end-to-end rate this family's cells report, and what one sample is
RATE = "train_tokens_per_s"
UNIT = "tokens/s"


def units_per_sample(traffic):
    return int(traffic["seq_len"])


def step_flops(config, traffic):
    return yardstick.lm_step_flops(config["model"], traffic)


def configure(root, config, traffic):
    """``root.lm`` for this configuration and traffic; the decision never
    ends the run."""
    d, heads, layers, f, v = ref.shape(config["model"])
    root.update(config.get("root", {}))
    root.lm.update({
        "loader": {"minibatch_size": int(traffic["minibatch_size"]),
                   "n_train": int(traffic["n_train"]),
                   "n_valid": int(traffic["n_valid"]),
                   "seq_len": int(traffic["seq_len"]), "vocab": v,
                   "max_period": int(traffic["max_period"]),
                   "text_file": None},
        "model": {"dim": d, "heads": heads, "layers": layers,
                  "ffn_hidden": f},
        "train": dict(config["train"]),
        "decision": {"max_epochs": 10 ** 9, "fail_iterations": 10 ** 9},
    })


def make_data(config, traffic, seed, device):
    """{"data": int32 (N, S), "labels": int64 (N, S)}: periodic sequences
    (each repeats a random pattern of a random period from 2 to
    ``max_period``), labels the next token; rows [valid | train]."""
    v = int(config["model"]["vocab_size"])
    s = int(traffic["seq_len"])
    n = int(traffic["n_train"]) + int(traffic["n_valid"])
    p = int(traffic["max_period"])
    gen = inputs.generator(seed, device)
    periods = torch.randint(2, p + 1, (n, 1), generator=gen, device=device)
    patterns = torch.randint(0, v, (n, p), generator=gen, device=device)
    pos = torch.arange(s + 1, device=device)[None, :] % periods
    seqs = torch.gather(patterns, 1, pos)
    return {"data": seqs[:, :-1].to(torch.int32).contiguous(),
            "labels": seqs[:, 1:].contiguous()}


def make_inputs(config, traffic, seed, device):
    """(parameters, data, seeds) of a run."""
    sd = inputs.seeds(seed)
    params = inputs.make_params(ref.leaves(config["model"]), sd["params"],
                                device)
    return params, make_data(config, traffic, sd["data"], device), sd


def attach(wf, data, traffic):
    """The loader serves ``data`` (on the device) in place of its own
    corpus: its rows, classes and sample shape are the benchmark's."""
    loader = wf.loader
    n_valid, n_train = int(traffic["n_valid"]), int(traffic["n_train"])
    s = int(traffic["seq_len"])

    def load_data():
        n = n_valid + n_train
        loader.original_data = numpy.broadcast_to(
            numpy.zeros((1, s), numpy.int32), (n, s))
        loader.original_labels = loader.original_data
        loader.class_lengths = [0, n_valid, n_train]
        loader.serve_dtype = numpy.int32

    loader.load_data = load_data
    loader.device_full_arrays = lambda device: data
    return wf


def program_leaves(wf, config):
    """[(leaf name, forward unit, its parameter name, GD unit)] in the
    reference's order, each checked against the reference's shape."""
    d, heads, layers, f, v = ref.shape(config["model"])
    fw, gds = wf.forwards, wf.gds
    units = {"emb": (0, "weights"), "head.w": (len(fw) - 1, "weights"),
             "head.b": (len(fw) - 1, "bias")}
    for i in range(layers):
        base, p = 1 + 4 * i, "l%d." % i
        units.update({
            p + "qkv.w": (base, "weights"), p + "qkv.b": (base, "bias"),
            p + "out.w": (base, "weights_out"),
            p + "out.b": (base, "bias_out"),
            p + "ln1.g": (base + 1, "weights"),
            p + "ln1.b": (base + 1, "bias"),
            p + "ffn1.w": (base + 2, "weights"),
            p + "ffn1.b": (base + 2, "bias"),
            p + "ffn2.w": (base + 2, "weights2"),
            p + "ffn2.b": (base + 2, "bias2"),
            p + "ln2.g": (base + 3, "weights"),
            p + "ln2.b": (base + 3, "bias")})
    if len(fw) != 2 + 4 * layers or getattr(fw[1], "heads", None) != heads:
        raise ValueError("the program's LM is not the configured one: %d "
                         "units" % len(fw))
    out = []
    for name, shape, _, _, _ in ref.leaves(config["model"]):
        i, attr = units[name]
        t = getattr(fw[i], attr)
        if t is None or tuple(t.shape) != tuple(shape):
            raise ValueError("%s (%s.%s): shape %s, the reference's %s" % (
                name, fw[i].name, attr, None if t is None else
                tuple(t.shape), shape))
        out.append((name, fw[i], attr, gds[i]))
    return out


def install(wf, params, sd, config):
    """Hand the program the benchmark's parameters (a copy each) and its
    shuffle seed; -> :func:`program_leaves`."""
    leaves = program_leaves(wf, config)
    for name, unit, attr, _ in leaves:
        setattr(unit, attr, params[name].clone())
    wf.loader.prng.seed(sd["shuffle"])
    return leaves


def hyper(config):
    """{leaf: (lr, moment, l2)} of the program's solver settings."""
    t = config["train"]
    lr, m = float(t["learning_rate"]), float(t["gradient_moment"])
    l2 = float(t.get("weights_decay", 0.0))
    return {name: (lr, m, 0.0 if kind == "b" else l2)
            for name, _, kind, _, _ in ref.leaves(config["model"])}


def unit_states(wf):
    """The generator states the units draw from in a train step: none."""
    return None


def reference_batches(data, rows, device, config, sd, states=None):
    """The train minibatches of ``rows`` as the reference takes them."""
    out = []
    for idx in rows:
        i = torch.as_tensor(numpy.asarray(idx, numpy.int64), device=device)
        out.append((data["data"][i], data["labels"][i]))
    return out


def reference_loss(config, prec, half=False):
    """The reference's loss of a minibatch; ``half`` (a fault planted for
    the check) takes the mean over its first half of rows."""
    def loss(params, batch):
        if half:
            batch = tuple(t[:t.shape[0] // 2] for t in batch)
        return ref.loss(params, batch, config["model"], prec)
    return loss
