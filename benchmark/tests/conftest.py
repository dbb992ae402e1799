"""Fixtures of the benchmark's own tests: the harness's modules on the
path, and tiny cells of each family for the CPU.

Run them with ``python3 -m pytest benchmark/tests -q`` from the root of
the repository. Tests marked ``cuda`` (the repository's marker for tests
that need a card) skip without one; run them on the card with ``-m
cuda``.
"""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_lm_config():
    """The LM configuration at widths a CPU test can hold."""
    config = load("configs", "lm110m.json")
    config["model"].update(hidden_size=32, num_attention_heads=4,
                           num_hidden_layers=2, intermediate_size=64,
                           vocab_size=50)
    config["root"]["lm"]["model"]["attn_block"] = 8
    return config


def tiny_alexnet_config():
    """The AlexNet configuration on small images and 10 classes (the
    program's sample fixes its layer widths)."""
    config = load("configs", "alexnet.json")
    config["model"].update(scale=[72, 72], crop=[67, 67], num_classes=10)
    return config


def make_cell(family, config, traffic, limits):
    import importlib

    import harness
    return harness.Cell("tiny." + family, config, traffic, limits, 1,
                        importlib.import_module("families." + family))


@pytest.fixture
def tiny_lm():
    """A tiny LM cell held to the limits of ``lm110m.s512.b64``."""
    return make_cell(
        "lm", tiny_lm_config(),
        {"minibatch_size": 8, "seq_len": 16, "n_train": 32, "n_valid": 8,
         "max_period": 4, "trace_steps": 2},
        load("workloads", "lm110m.s512.b64.json")["limits"])


@pytest.fixture
def tiny_alexnet():
    """A tiny AlexNet cell held to the limits of ``alexnet.b256``."""
    return make_cell(
        "alexnet", tiny_alexnet_config(),
        {"minibatch_size": 4, "n_train": 16, "n_valid": 4,
         "trace_steps": 2},
        load("workloads", "alexnet.b256.json")["limits"])
