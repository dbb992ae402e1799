"""The port's MNIST chain (veles_torch) against the JAX package run on
the CPU: same seed -> the same data, initial weights and shuffles bit
for bit; one train step and one epoch from the same state agree within
float32 tolerance (the matmuls sum in another order); 3 epochs of the
full sample reach the same validation error. The JAX side runs with
``fused_bias_grad`` on, so its Pallas bias-gradient kernel runs in
interpret mode."""

import contextlib
import copy
import json
import os

import jax
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu.models import datasets as jdatasets
from veles.znicz_tpu.models.mnist import MnistLoader as JaxMnistLoader
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.backends import TorchDevice
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.znicz.models import datasets as tdatasets
from veles_torch.znicz.models.mnist import MnistLoader as TorchMnistLoader
from veles_torch.znicz.standard_workflow import \
    StandardWorkflow as TorchStandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "veles_torch", "znicz", "models", "mnist.py")
#: the small config of the step/epoch parity tests
SMALL = dict(minibatch_size=20, n_train=100, n_valid=40)
#: the published sample config (models/mnist.py of both packages)
FULL = dict(minibatch_size=100, n_train=6000, n_valid=1000)


def _layers(fused=None):
    gd = {"learning_rate": 0.02, "weights_decay": 0.0,
          "gradient_moment": 0.5, "fused_bias_grad": fused}
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
             "<-": dict(gd)},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


def jax_workflow(sizes, max_epochs, fused=None, seed=1337):
    """The reference MNIST chain on ``-d cpu``, initialized."""
    jprng.seed_all(seed)
    mb = sizes["minibatch_size"]
    wf = JaxStandardWorkflow(
        None, name="JaxMnist", layers=_layers(fused),
        loader_factory=lambda w: JaxMnistLoader(
            w, name="loader", minibatch_size=mb,
            n_train=sizes["n_train"], n_valid=sizes["n_valid"]),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    wf.initialize(device="cpu")
    return wf


def torch_workflow(sizes, max_epochs, seed=1337):
    """The port's MNIST chain on the CPU, initialized."""
    tprng.seed_all(seed)
    mb = sizes["minibatch_size"]
    wf = TorchStandardWorkflow(
        name="TorchMnist", layers=_layers(),
        loader_factory=lambda w: TorchMnistLoader(
            w, name="loader", minibatch_size=mb,
            n_train=sizes["n_train"], n_valid=sizes["n_valid"]),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    return wf.initialize(device="cpu")


def jax_tree(wf):
    """{unit: {key: ndarray}} of the reference's params and state."""
    return {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}


def assert_trees_close(want, got, atol):
    assert sorted(want) == sorted(got)
    for unit in want:
        assert sorted(want[unit]) == sorted(got[unit]), unit
        for key, value in want[unit].items():
            value = numpy.asarray(value)
            diff = numpy.abs(got[unit][key].astype(numpy.float64)
                             - value.astype(numpy.float64)).max()
            assert diff <= atol, (unit, key, diff)


@pytest.fixture
def restore_port_root():
    saved = copy.deepcopy(troot.mnist.to_dict())
    yield
    troot.mnist.update(saved)


def test_same_seed_same_data_and_weights():
    """At seed 1337 the synthetic MNIST arrays, the initial weights and
    the first train shuffle are bitwise those of the JAX package."""
    jprng.seed_all(1337)
    want = jdatasets.load_mnist(n_train=300, n_valid=50)
    tprng.seed_all(1337)
    got = tdatasets.load_mnist(n_train=300, n_valid=50)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and numpy.array_equal(w, g)
    jw = jax_workflow(SMALL, 1)
    tw = torch_workflow(SMALL, 1)
    jt = jax_tree(jw)
    tt = params_to_numpy(tw.export_tree())
    for unit in ("All2AllTanh", "All2AllSoftmax"):
        for key in ("weights", "bias"):
            assert numpy.array_equal(jt[unit][key], tt[unit][key]), \
                (unit, key)
    assert numpy.array_equal(jw.loader.class_schedule(2)[0],
                             tw.loader.class_schedule(2)[0])


@contextlib.contextmanager
def bf16_policy():
    """The card's dtype policy in both packages on the CPU:
    ``root.common.engine.amp = compute_dtype = "bfloat16"`` (products of
    bf16-rounded inputs, returned in f32; bf16 activations and error
    flows), cleared after."""
    try:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = "bfloat16"
        yield
    finally:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = None


def one_step(jw, tw):
    """One train step of both workflows from the reference's state ->
    (reference tree, port tree, reference outputs, port metrics)."""
    tw.import_tree(params_from_jax(jax_tree(jw)))
    idx_mat, valids = jw.loader.class_schedule(2)
    data = jw.loader.original_data.mem[idx_mat[0]]
    labels = jw.loader.original_labels.mem[idx_mat[0]]
    step = jw.xla_step
    fn = step.compiler.compile(step._batch_spec, train=True)
    params, state, outs = fn(
        step.params, step.state,
        {"data": data, "labels": labels,
         "batch_size": numpy.int32(valids[0])},
        step._gather_hyper(), jax.random.PRNGKey(0))
    metrics = tw.step.train_minibatch(
        torch.from_numpy(data), torch.from_numpy(labels.astype(numpy.int64)),
        torch.tensor(int(valids[0])))
    want = {u: {**params.get(u, {}), **state.get(u, {})}
            for u in set(params) | set(state)}
    want = {u: {k: numpy.asarray(v) for k, v in sub.items()}
            for u, sub in want.items()}
    return want, params_to_numpy(tw.export_tree()), outs, metrics


def test_one_train_step_matches_reference():
    """One train step from the same state (the reference's exported
    tree, converted by params_from_jax): weights, bias and velocities
    agree to 1e-5, and so do the step's loss and error count."""
    jw = jax_workflow(SMALL, 1, fused=True)
    tw = torch_workflow(SMALL, 1)
    want, got, outs, metrics = one_step(jw, tw)
    assert_trees_close(want, got, 1e-5)
    # from zero velocity, vel = -lr·grad: the gradients themselves agree
    # to float32 summation-order error
    for unit in ("GDTanh", "GDSoftmax"):
        for key in ("vel_weights", "vel_bias"):
            numpy.testing.assert_allclose(got[unit][key], want[unit][key],
                                          rtol=1e-4, atol=1e-8)
    assert abs(float(outs["loss"]) - float(metrics[0])) < 1e-5
    assert int(outs["n_err"]) == int(metrics[1])


#: the step under the card's dtype policy (bf16 products and
#: activations): each gradient against the reference's largest element.
#: The products are f32 sums of the same bf16-rounded inputs, so they
#: agree to f32 order error (observed: 0 and 9.4e-8; a product rounded to
#: bf16, as the port's ``dot`` once did, reads 1.9e-3 to 6.1e-3). GDTanh's
#: weight gradient is looser: XLA on the CPU folds the bf16 rounding of
#: dz = err·act'(y) into its f32 product, which the traced code asks for
#: and the port keeps (observed 2.0e-3, and 4.6e-3 with the fault)
BF16_STEP_RTOL = 1e-5
BF16_DZ_FOLD_RTOL = 1e-2


def test_one_train_step_matches_reference_bf16_policy():
    """The same step under the card's dtype policy, held on the CPU:
    the softmax layer's gradients and the tanh layer's bias gradient
    within BF16_STEP_RTOL of the reference's largest element, the tanh
    layer's weight gradient within BF16_DZ_FOLD_RTOL; the same loss (to
    1e-5) and error count."""
    with bf16_policy():
        jw = jax_workflow(SMALL, 1, fused=True)
        tw = torch_workflow(SMALL, 1)
        assert tw.device.compute_dtype == tw.device.act_dtype == \
            torch.bfloat16
        want, got, outs, metrics = one_step(jw, tw)
    for unit, key, rtol in (("GDSoftmax", "vel_weights", BF16_STEP_RTOL),
                            ("GDSoftmax", "vel_bias", BF16_STEP_RTOL),
                            ("GDTanh", "vel_bias", BF16_STEP_RTOL),
                            ("GDTanh", "vel_weights", BF16_DZ_FOLD_RTOL)):
        w = want[unit][key].astype(numpy.float64)
        diff = numpy.abs(got[unit][key] - w).max() / numpy.abs(w).max()
        assert diff <= rtol, (unit, key, diff)
    assert abs(float(outs["loss"]) - float(metrics[0])) < 1e-5
    assert int(outs["n_err"]) == int(metrics[1])


def test_one_epoch_matches_reference():
    """One whole epoch (validation then 5 train steps, same shuffle):
    params within 1e-4 and equal per-class error counts."""
    jw = jax_workflow(SMALL, 1, fused=True)
    tw = torch_workflow(SMALL, 1)
    tw.import_tree(params_from_jax(jax_tree(jw)))
    jw.run()
    tw.run()
    assert_trees_close(jax_tree(jw), params_to_numpy(tw.export_tree()),
                       1e-4)
    (jh,), (th,) = jw.decision.history, tw.decision.history
    for cls in ("validation", "train"):
        assert jh[cls]["samples"] == th[cls]["samples"]
        assert round(jh[cls]["metric"] * jh[cls]["samples"]) == \
            round(th[cls]["metric"] * th[cls]["samples"]), cls
        assert abs(jh[cls]["loss"] - th[cls]["loss"]) < 1e-4


def test_three_epochs_match_reference():
    """The full sample (784-100-10, minibatch 100, 6000/1000) for 3
    epochs at seed 1337: the port's final validation error is within
    0.02 of the JAX package's on -d cpu."""
    jw = jax_workflow(FULL, 3)
    jw.run()
    tw = torch_workflow(FULL, 3)
    tw.run()
    err_j = jw.decision.history[-1]["validation"]["metric"]
    err_t = tw.decision.history[-1]["validation"]["metric"]
    assert len(tw.decision.history) == 3
    assert err_t < 0.15
    assert abs(err_j - err_t) < 0.02, (err_j, err_t)


def test_entry_point_needs_a_card_unless_cpu(restore_port_root):
    """Without -d the entry point asks for cuda, which a card-less
    host refuses; nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([MNIST, "root.mnist.decision.max_epochs=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDevice("cuda")
    assert TorchDevice("cpu").act_dtype == torch.float32


def test_entry_point_runs_on_cpu(restore_port_root, tmp_path, capsys):
    result = tmp_path / "result.json"
    wf = torch_main([MNIST, "root.mnist.decision.max_epochs=2",
                     "root.mnist.loader.n_train=200",
                     "root.mnist.loader.n_valid=50",
                     "root.mnist.loader.minibatch_size=50",
                     "-d", "cpu", "--seed", "3",
                     "--result-file", str(result)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu"
    assert len(last["history"]) == 2
    assert last == json.loads(result.read_text())
    assert wf.step.train_steps == 8
    assert wf.forwards[0].weights.shape == (784, 100)


def test_dtype_policy_follows_config():
    """f32 on the CPU by default; root.common.engine.amp /
    compute_dtype override it, and an unknown dtype is refused."""
    engine = troot.common.engine
    saved = engine.to_dict()
    try:
        dev = TorchDevice("cpu")
        assert dev.compute_dtype == dev.act_dtype == torch.float32
        assert dev.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        engine.amp = "bfloat16"
        engine.compute_dtype = "bfloat16"
        dev = TorchDevice("cpu")
        assert dev.act_dtype == dev.compute_dtype == torch.bfloat16
        assert dev.dot(torch.ones(2, 3), torch.ones(3, 4)).dtype == \
            torch.float32
        engine.amp = "float64"
        with pytest.raises(ValueError):
            TorchDevice("cpu")
        with pytest.raises(ValueError):
            TorchDevice("tpu")
    finally:
        engine.update(saved)


def test_config_overrides():
    troot.test_cfg.update({"a": {"b": 1}})
    troot.apply_override("root.test_cfg.a.b=2.5")
    troot.apply_override("test_cfg.a.name=word")
    troot.apply_override("test_cfg.c.d=[1, 2]")
    assert troot.test_cfg.to_dict() == {
        "a": {"b": 2.5, "name": "word"}, "c": {"d": [1, 2]}}
    for bad in ("test_cfg.a.b", "test_cfg..b=1", "=3"):
        with pytest.raises(ValueError):
            troot.apply_override(bad)


def test_params_round_trip():
    tree = {"All2AllTanh": {"weights": numpy.ones((3, 2), numpy.float32)},
            "GDTanh": {"iteration": numpy.int32(7)}}
    back = params_to_numpy(params_from_jax(tree))
    assert back["GDTanh"]["iteration"].dtype == numpy.int32
    assert int(back["GDTanh"]["iteration"]) == 7
    assert numpy.array_equal(back["All2AllTanh"]["weights"],
                             tree["All2AllTanh"]["weights"])


def test_torch_generator_bridge_is_seeded_by_name():
    tprng.seed_all(11)
    a = torch.rand(4, generator=tprng.torch_generator("dropout"))
    b = torch.rand(4, generator=tprng.torch_generator("dropout"))
    c = torch.rand(4, generator=tprng.torch_generator("other"))
    assert torch.equal(a, b) and not torch.equal(a, c)
