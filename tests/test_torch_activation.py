"""The port's standalone activation pairs (veles_torch/znicz/ops/
activation.py) against the JAX package's (veles/znicz_tpu/ops/
activation.py) on the CPU: each pair built as tests/test_conv_stack.py
builds its units (the same seeded input and error), the forward output
and ``err_input`` within ``ATOL``; the registry names, the export rule
and a workflow that trains through a pair."""

import json

import numpy
import pytest
import torch

import veles.prng as jprng
from veles.export_inference import ENGINE_TYPES as JAX_ENGINE_TYPES
from veles.znicz_tpu.models.mnist import MnistLoader as JaxMnistLoader
from veles.znicz_tpu.nn_units import forward_by_name as jax_forward_by_name
from veles.znicz_tpu.ops import activation as JA
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_torch.backends import TorchDevice
from veles_torch.export_inference import export_inference
from veles_torch.znicz.nn_units import forward_by_name, gradient_unit_for
from veles_torch.znicz.ops import activation as TA

from tests.test_conv_stack import build, xla_backward, xla_forward
from tests.test_torch_resume import SMALL, assert_atol, port_tree, \
    torch_mnist

#: forward and err_input against the reference (values of order 1): the
#: same f32 formulas, transcendental functions of another library
#: (observed at most 4.8e-7)
ATOL = 2e-5

#: (config name, class name) of the eight pairs
PAIRS = [("activation_tanh", "ForwardTanh"),
         ("activation_relu", "ForwardRELU"),
         ("activation_str", "ForwardStrictRELU"),
         ("activation_sigmoid", "ForwardSigmoid"),
         ("activation_log", "ForwardLog"),
         ("activation_mul", "ForwardMul"),
         ("activation_tanhlog", "ForwardTanhLog"),
         ("activation_sincos", "ForwardSinCos")]


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = numpy.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = numpy.abs(got.astype(numpy.float64) - want).max()
    assert diff <= atol, diff


@pytest.mark.parametrize("name,cls_name", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("scale", [1.0, 4.0], ids=["x1", "x4"])
def test_pair_matches_reference(name, cls_name, scale):
    """Forward and ``err_input`` against the reference's traced unit and
    its numpy oracle; ×4 inputs reach tanhlog's log branch and the
    saturated tails."""
    jcls = getattr(JA, cls_name)
    wf, feed, jf, jg, x, err, comp = build(jcls, gd_kwargs={})
    x = (x * scale).astype(numpy.float32)
    want_y = xla_forward(comp, feed, jf, {}, x)
    want_ei, _ = xla_backward(comp, feed, jf, jg, {}, {}, x, err)
    jf.input.mem[...] = x
    jf.numpy_run()
    fwd = getattr(TA, cls_name)()
    assert fwd.name == type(jf).__name__
    fwd.initialize(x.shape, TorchDevice("cpu"))
    gd = gradient_unit_for(type(fwd))(learning_rate=1.0).setup_forward(fwd)
    gd.initialize()
    xt = torch.from_numpy(x)
    y = fwd(xt)
    close(y, want_y)
    close(y, jf.output.mem)
    ei = gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32)))
    close(ei, want_ei)


@pytest.mark.parametrize("name,cls_name", PAIRS, ids=[p[0] for p in PAIRS])
def test_registry_and_export_rule(name, cls_name, tmp_path):
    """Each pair under the reference's config name and class names; an
    archive takes the four the engines know, as the reference's
    exporter, and refuses the other four."""
    cls = forward_by_name(name)
    jcls = jax_forward_by_name(name)
    assert cls is getattr(TA, cls_name)
    assert cls.__name__ == jcls.__name__
    assert gradient_unit_for(cls).__name__ == \
        "ActivationBackward_%s" % name.split("_")[-1]

    class Chain:
        name = "Chain"
        loader = None
        forwards = [cls()]

    Chain.forwards[0].initialize((4, 6), TorchDevice("cpu"))
    Chain.forwards[0].input_shape = (4, 6)
    if name in JAX_ENGINE_TYPES:
        with open(export_inference(Chain, str(tmp_path))) as f:
            units = json.load(f)["units"]
        assert [u["type"] for u in units] == [name]
    else:
        with pytest.raises(ValueError, match="no C\\+\\+ engine"):
            export_inference(Chain, str(tmp_path))


def _layers(act):
    gd = {"learning_rate": 0.02, "gradient_moment": 0.5}
    return [{"type": "all2all", "->": {"output_sample_shape": 24},
             "<-": dict(gd)},
            {"type": act},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


@pytest.mark.parametrize("act", ["activation_tanhlog", "activation_sincos"])
def test_workflow_trains_through_a_pair(act):
    """A dense -> pair -> softmax chain trains two MNIST epochs in both
    packages: the same parameters (MNIST's bound) and history."""
    jprng.seed_all(1337)
    jw = JaxStandardWorkflow(
        None, name="Act", layers=_layers(act),
        loader_factory=lambda w: JaxMnistLoader(
            w, name="loader", minibatch_size=SMALL["minibatch_size"],
            n_train=SMALL["n_train"], n_valid=SMALL["n_valid"]),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    jw.initialize(device="cpu")
    jw.run()
    tw = torch_mnist(2, layers=_layers(act))
    tw.run()
    want = {u.name: {**u.export_params(), **u.export_state()}
            for u in jw.forwards + jw.gds}
    assert_atol({u: s for u, s in want.items() if s}, port_tree(tw), 1e-6)
    for jh, th in zip(jw.decision.history, tw.decision.history):
        assert jh["validation"]["metric"] == th["validation"]["metric"]
        assert abs(jh["train"]["loss"] - th["train"]["loss"]) < 1e-6
    assert [type(f).__name__ for f in tw.forwards] == \
        [type(f).__name__ for f in jw.forwards]
