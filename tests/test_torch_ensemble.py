"""The port's Ensemble (veles_torch/ensemble.py, ``--ensemble N``)
against the JAX package's (veles/ensemble.py) on the CPU: three MNIST
members from the same seeds give the same member errors and ensemble
error over the same validation rows, the mean outputs within float32
tolerance of the reference's; the CLI prints and writes the reference's
report."""

import json
import os

import numpy
import pytest
import torch

from veles.config import root as jroot
from veles.ensemble import Ensemble as JEnsemble
from veles.znicz_tpu.models import mnist as jmnist
from veles_torch import model_health as TMH
from veles_torch.__main__ import import_file, main as torch_main
from veles_torch.config import root as troot
from veles_torch.ensemble import Ensemble as TEnsemble
from veles_torch.znicz.models import mnist as tmnist

from tests.torch_monitor import port_model_health_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models", "mnist.py")
#: the reference test's ensemble (tests/test_genetics_ensemble.py)
SIZES = {"n_train": 300, "n_valid": 100, "minibatch_size": 50}
#: the members' mean softmax outputs, port against reference: float32
#: products summed in another order over 2 epochs of training (read:
#: 8.9e-8)
MEAN_ATOL = 1e-6


@pytest.fixture(scope="module")
def ensembles():
    """Both packages' 3-member ensembles (base seed 42, 2 epochs at
    SIZES), trained; ``root.mnist`` restored after. The reference trains
    on ``-d cpu``, its fused step, which the port's step follows: its
    numpy oracle skips the last minibatch's update once the decision
    completes (11 updates in 12 minibatches here), so its members end one
    update away from both."""
    saved = []
    for r in (jroot, troot):
        saved.append((r, {k: r.mnist.loader.get(k) for k in SIZES},
                      r.mnist.decision.max_epochs))
        r.mnist.loader.update(SIZES)
        r.mnist.decision.max_epochs = 2
    try:
        ref = JEnsemble(lambda name: jmnist.create_workflow(name=name),
                        n_models=3, base_seed=42, device="cpu")
        ref.train()
        with TMH.scoped():
            port = TEnsemble(lambda name: tmnist.create_workflow(name=name),
                             n_models=3, base_seed=42, device="cpu")
            port.train()
    finally:
        for r, loader, epochs in saved:
            r.mnist.loader.update(loader)
            r.mnist.decision.max_epochs = epochs
    return ref, port


def test_report_equals_reference(ensembles):
    """Equal member errors, ensemble error and ``n_valid``; the mean of
    softmax outputs is no worse than the weakest member (the reference
    test's bar)."""
    ref, port = ensembles
    want = ref.evaluate_classification()
    got = port.evaluate_classification()
    assert sorted(got) == ["ensemble_error", "member_errors", "n_valid"]
    assert got == want
    assert got["n_valid"] == 100 and len(got["member_errors"]) == 3
    assert got["ensemble_error"] <= max(got["member_errors"])
    assert [wf.name for wf in port.workflows] == \
        ["ensemble_m0", "ensemble_m1", "ensemble_m2"]


def test_members_and_mean_outputs_match_reference(ensembles):
    """Each member's history of validation errors equals the reference
    member's; ``predict`` on a minibatch of rows (and the port's on a
    short batch) is within MEAN_ATOL of the reference's mean outputs and
    sums to 1 a row."""
    ref, port = ensembles
    for jw, tw in zip(ref.workflows, port.workflows):
        assert [h["validation"]["metric"] for h in tw.decision.history] == \
            [h["validation"]["metric"] for h in jw.decision.history]
    loader = port.workflows[0].loader
    rows = numpy.asarray(loader.original_data[:SIZES["minibatch_size"]])
    want = ref.predict(rows)
    got = port.predict(rows)
    assert got.dtype == numpy.float32 and got.shape == want.shape
    assert numpy.abs(got - want).max() <= MEAN_ATOL
    numpy.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    # the port's members take a batch of any size (the reference's fills
    # its minibatch array, so only its size)
    assert numpy.abs(port.predict(rows[:7]) - want[:7]).max() <= MEAN_ATOL


def test_member_forward_is_the_eval_forward(ensembles):
    """A member's outputs are its eval forward's: the forwards end in eval
    mode, no gradient is recorded, and no parameter changes."""
    _, port = ensembles
    wf = port.workflows[1]
    before = {k: v.clone() for k, v in wf.forwards[0].export_params().items()}
    x = numpy.asarray(wf.loader.original_data[:5])
    out = port._member_outputs(x)[1]
    with torch.no_grad():
        _, last = wf.step._forward(torch.as_tensor(x), False)
    numpy.testing.assert_array_equal(out, last.numpy())
    assert not any(f.training for f in wf.forwards)
    for k, v in wf.forwards[0].export_params().items():
        assert torch.equal(v, before[k]) and not v.requires_grad


def test_cli_ensemble_prints_and_writes_the_report(tmp_path, capsys):
    """``--ensemble 2 -d cpu --seed 42``: the last stdout line is the
    report, ``--result-file`` holds it, and it equals the report of the
    API's ensemble on the same seeds; ``root`` is left as it was."""
    result = tmp_path / "ens.json"
    ens = torch_main([TORCH_MNIST, "-d", "cpu", "--seed", "42",
                      "--ensemble", "2", "--result-file", str(result),
                      *("root.mnist.loader.%s=%d" % kv
                        for kv in SIZES.items()),
                      "root.mnist.decision.max_epochs=2"])
    out = capsys.readouterr().out.strip().splitlines()
    doc = json.loads(out[-1])
    assert json.loads(result.read_text()) == doc
    assert sorted(doc) == ["ensemble_error", "member_errors", "n_valid"]
    assert len(doc["member_errors"]) == 2 and doc["n_valid"] == 100
    assert isinstance(ens, TEnsemble) and len(ens.workflows) == 2
    assert all(str(wf.device.device) == "cpu" for wf in ens.workflows)
    try:
        # root.mnist is as the CLI's overrides left it
        api = TEnsemble(lambda name: tmnist.create_workflow(),
                        n_models=2, base_seed=42, device="cpu")
        api.train()
        assert api.evaluate_classification() == doc
    finally:
        import_file(TORCH_MNIST, "veles_torch_mnist_defaults")
    assert troot.mnist.loader.n_train == 6000
    assert troot.mnist.decision.max_epochs == 5
