"""Data parallelism of the port's workflows whose step is their own body
(veles_torch/znicz/ops/kohonen.py, ops/rbm.py under
``parallel.setup_data_parallel``) and of the stream path, on 2 gloo ranks
of this host (tests/torch_parallel_workers.py):

* the SOM under ``data=2`` against the reference's one-device run and the
  port's one process: the winners local, the pull's sums all-reduced, the
  same weights and stop on every rank;
* the RBM's CD-1 steps under ``data=2`` with the minibatch's uniforms
  injected, against the reference's units (``numpy_run``); the MnistRBM
  sample under ``data=2`` against the port's one process: the binarize
  uniforms and the first step's samples bit for bit, the error and the
  weights within 1e-5;
* a streamed MNIST MLP (``ArrayStreamLoader``) under ``data=2`` with
  minibatches the ranks do not divide (12 with partial last minibatches,
  13), against one process.
"""

import numpy
import pytest

import veles.prng as jprng
from veles.config import root as jroot
from veles.workflow import Workflow
from veles.znicz_tpu.models import kohonen as jkoh
from veles.znicz_tpu.ops import all2all as JA
from veles.znicz_tpu.ops import rbm as JR
from tests.test_all2all import FeedUnit
from tests.torch_parallel_workers import RankGroup

#: the SOM's weights, DP against one device: f32 sums of two shards in
#: another order (observed ≤ 3e-7 of the largest element)
SOM_ATOL = 1e-5
#: the RBM's weights and errors, DP against one device
RBM_ATOL = 1e-5
#: the streamed MLP's parameters, DP against one process
STREAM_ATOL = 1e-5

DATA2 = (("data", 2),)


@pytest.fixture(scope="module")
def group2():
    group = RankGroup(2)
    yield group
    group.close()


def close(got, want, share, what):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    assert got.shape == want.shape, what
    diff = numpy.abs(got - want).max(initial=0.0)
    limit = share * max(numpy.abs(want).max(initial=0.0), 1e-30)
    assert diff <= limit, (what, diff, limit)


SOM_LOADER = {"n_samples": 610, "minibatch_size": 50}


def test_som_under_data2_matches_reference_and_one_process(group2):
    """600 + 10 points (the last minibatch: 10 valid rows, all on rank 0),
    6 epochs: every rank holds the same weights, within 1e-5 of the
    reference's one-device run and of the port's one process; the
    histories' train metric (the map's RMS move) agree within 1e-5
    relative; one all-reduce a train step."""
    saved = jroot.kohonen.to_dict()
    try:
        jroot.kohonen.update({"decision": {"max_epochs": 6},
                              "loader": dict(SOM_LOADER)})
        jprng.seed_all(77)
        jw = jkoh.create_workflow(name="Koh")
        jw.initialize(device="cpu")
        jw.run()
        want_w = jw.forwards[0].weights.map_read().mem
        want_h = jw.decision.history
    finally:
        jroot.kohonen.update(saved)
    dp = group2.run("som_run", DATA2, 6, SOM_LOADER, 77)
    one = group2.run("som_run", (), 6, SOM_LOADER, 77)[0]
    numpy.testing.assert_array_equal(dp[0]["weights"], dp[1]["weights"])
    assert dp[0]["history"] == dp[1]["history"]
    close(dp[0]["weights"], want_w, SOM_ATOL, "SOM vs the reference")
    close(dp[0]["weights"], one["weights"], SOM_ATOL, "SOM vs one process")
    assert dp[0]["time_step"] == one["time_step"] == 6 * 13
    assert len(dp[0]["history"]) == len(want_h) == 6
    for got, ref in zip(dp[0]["history"], want_h):
        assert got["train"]["samples"] == ref["train"]["samples"] == 610
        assert abs(got["train"]["metric"] - ref["train"]["metric"]) \
            <= 1e-5 * ref["train"]["metric"]
    assert dp[0]["counts"] == {"all-reduce": 1}
    assert one["counts"] == {}


def _jax_rbm_steps(params, batches, uniforms, valids, lr):
    """The reference's CD-1 units (``numpy_run``, the uniforms injected)
    over the minibatches -> (each step's mse, the final w, hb, vb)."""
    class Uniforms:
        def __init__(self):
            self.u = None

        def random_sample(self, shape):
            assert tuple(shape) == self.u.shape
            return self.u
    mb, visible = batches[0].shape
    hidden = uniforms[0].shape[1]
    wf = Workflow(None, name="wf")
    feed = FeedUnit(wf, batches[0].copy())
    h_pos = JA.All2AllSigmoid(wf, name="h_pos", output_sample_shape=hidden)
    h_pos.link_attrs(feed, ("input", "minibatch_data"))
    h_pos.initialize(device=None)
    h_pos.weights.mem[...] = params["w"]
    h_pos.bias.mem[...] = params["hb"]
    binarize = JR.Binarization(wf, name="binarize")
    binarize.link_attrs(h_pos, ("input", "output"))
    binarize.initialize(device=None)
    binarize.rand = Uniforms()
    v_neg = JR.TiedAll2AllSigmoid(wf, name="v_neg", weights_source=h_pos,
                                  transposed=True,
                                  output_sample_shape=visible)
    v_neg.link_attrs(binarize, ("input", "output"))
    v_neg.initialize(device=None)
    v_neg.bias.mem[...] = params["vb"]
    h_neg = JR.TiedAll2AllSigmoid(wf, name="h_neg", weights_source=h_pos,
                                  bias_source=h_pos,
                                  output_sample_shape=hidden)
    h_neg.link_attrs(v_neg, ("input", "output"))
    h_neg.initialize(device=None)
    stats = []
    for name, vsrc, hsrc in (("pos", (feed, "minibatch_data"),
                              (h_pos, "output")),
                             ("neg", (v_neg, "output"), (h_neg, "output"))):
        bw = JR.BatchWeights(wf, name=name)
        bw.link_attrs(vsrc[0], ("v", vsrc[1]))
        bw.link_attrs(hsrc[0], ("h", hsrc[1]))
        bw.initialize(device=None)
        stats.append(bw)
    evaluator = JR.EvaluatorRBM(wf, name="evaluator")
    evaluator.link_attrs(feed, ("v", "minibatch_data"))
    evaluator.link_attrs(v_neg, ("v_neg", "output"))
    grad = JR.GradientRBM(wf, name="gradient_rbm", learning_rate=lr)
    grad.hidden_layer, grad.visible_layer = h_pos, v_neg
    grad.pos_stats, grad.neg_stats = stats
    mses = []
    for batch, u, valid in zip(batches, uniforms, valids):
        feed.minibatch_data.map_invalidate()
        feed.minibatch_data.mem[...] = batch
        binarize.rand.u = u
        for unit in (h_pos, binarize, v_neg, h_neg):
            unit.numpy_run()
        for unit in stats + [evaluator]:
            unit.batch_size = valid
        for unit in stats + [evaluator, grad]:
            unit.numpy_run()
        mses.append(evaluator.mse)
    return mses, (h_pos.weights.mem.copy(), h_pos.bias.mem.copy(),
                  v_neg.bias.mem.copy())


def test_rbm_steps_under_data2_match_reference(group2):
    """Six CD-1 steps on minibatches of 10 rows of 30 visible units (the
    last two 7 and 5 valid: padded, masked, one rank short), 8 hidden,
    the minibatch's uniforms injected: the ranks' error shares sum to the
    reference's mse and the weights and both biases lie within 1e-5 of
    the reference's."""
    gen = numpy.random.Generator(numpy.random.PCG64(5))
    mb, visible, hidden, lr = 10, 30, 8, 0.1
    batches = [gen.random((mb, visible)).astype(numpy.float32)
               for _ in range(6)]
    uniforms = [gen.random((mb, hidden)) for _ in range(6)]
    valids = [10, 10, 10, 10, 7, 5]
    params = {"w": gen.normal(0, 0.3, (visible, hidden)).astype(
                  numpy.float32),
              "hb": gen.normal(0, 0.3, hidden).astype(numpy.float32),
              "vb": gen.normal(0, 0.3, visible).astype(numpy.float32)}
    want_mse, (w, hb, vb) = _jax_rbm_steps(params, batches, uniforms,
                                           valids, lr)
    got = group2.run("rbm_steps", DATA2, params, batches, uniforms, valids,
                     hidden, lr)
    for r in range(2):
        close(got[r]["w"], w, RBM_ATOL, "W on rank %d" % r)
        close(got[r]["hb"], hb, RBM_ATOL, "hidden bias")
        close(got[r]["vb"], vb, RBM_ATOL, "visible bias")
    for step, want in enumerate(want_mse):
        share = sum(float(got[r]["rows"][step][0]) for r in range(2))
        assert abs(share - want) <= RBM_ATOL * want, (step, share, want)


RBM_LOADER = {"n_train": 400, "n_valid": 100, "minibatch_size": 100}


def test_rbm_sample_under_data2_matches_one_process(group2):
    """The MnistRBM sample (784 -> 64) for 2 epochs under ``data=2``: the
    ranks' binarize uniforms put together are the one process's bit for
    bit, the first train step's samples too; every epoch's error within
    1e-5 relative and the weights within 1e-5 of the largest element;
    two all-reduces a train step (the positive and negative
    statistics)."""
    dp = group2.run("rbm_run", DATA2, 2, RBM_LOADER, 88)
    one = group2.run("rbm_run", (), 2, RBM_LOADER, 88)[0]
    assert len(one["uniforms"]) == len(dp[0]["uniforms"]) == 2 * (4 + 1)
    for step, whole in enumerate(one["uniforms"]):
        assert numpy.array_equal(
            numpy.concatenate([dp[0]["uniforms"][step],
                               dp[1]["uniforms"][step]]), whole), step
    assert numpy.array_equal(numpy.concatenate(
        [dp[0]["first_samples"], dp[1]["first_samples"]]),
        one["first_samples"])
    for got, want in zip(dp[0]["history"], one["history"]):
        for cls in ("train", "validation"):
            g, w = got[cls]["metric"], want[cls]["metric"]
            assert abs(g - w) <= RBM_ATOL * w, (cls, g, w)
    for unit, arrays in one["params"].items():
        for key, want in arrays.items():
            for r in range(2):
                close(dp[r]["params"][unit][key], want, RBM_ATOL,
                      (unit, key))
    assert dp[0]["counts"] == {"all-reduce": 2}


@pytest.mark.parametrize("minibatch", (12, 13))
def test_stream_dp_with_a_minibatch_the_ranks_do_not_fill(group2,
                                                         minibatch):
    """The stream path (``ArrayStreamLoader``, windows staged on the host)
    under ``data=2``: 109 train and 41 validation rows in minibatches of
    12 (the last ones partial: one rank's rows all padding) or 13 (padded
    to 14 in every minibatch); 2 epochs equal one process's within 1e-5,
    every rank the same parameters."""
    dp = group2.run("stream_dp", DATA2, minibatch, 31)
    one = group2.run("stream_dp", (), minibatch, 31)[0]
    assert dp[0]["history"] == dp[1]["history"]
    for got, want in zip(dp[0]["history"], one["history"]):
        for cls in ("train", "validation"):
            assert got[cls]["samples"] == want[cls]["samples"]
            assert got[cls]["metric"] == want[cls]["metric"]
            assert abs(got[cls]["loss"] - want[cls]["loss"]) \
                <= STREAM_ATOL * abs(want[cls]["loss"])
    for unit, arrays in one["params"].items():
        for key, want in arrays.items():
            numpy.testing.assert_array_equal(dp[0]["params"][unit][key],
                                             dp[1]["params"][unit][key])
            close(dp[0]["params"][unit][key], want, STREAM_ATOL,
                  (unit, key))
