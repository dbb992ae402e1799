"""The port's stream path (veles_torch/loader/stream.py and TorchStep's
windows) on the CPU: the same MNIST arrays streamed through
ArrayStreamLoader and served resident through FullBatchLoader give the
same decision history and parameters bit for bit (the windows are the
same float32 rows, sliced instead of gathered, through the same step),
windows of 2 and of 64 minibatches likewise, the uint8 transform, a stop
mid-epoch, and the port's streamed run against the JAX package's
streamed run (tests/test_stream.py) from the same weights."""

import numpy
import pytest
import torch

import veles.prng as jprng
from veles.loader.stream import ArrayStreamLoader as JaxArrayStreamLoader
from veles.znicz_tpu.models import datasets as jdatasets
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.loader.stream import ArrayStreamLoader
from veles_torch.znicz.models import datasets as tdatasets
from veles_torch.znicz.standard_workflow import StandardWorkflow
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: the reference test's sizes: 400/100 MNIST rows, minibatch 32
N_TRAIN, N_VALID, MB = 400, 100, 32


def _layers():
    gd = {"learning_rate": 0.02, "weights_decay": 0.0,
          "gradient_moment": 0.5}
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
             "<-": dict(gd)},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


def _arrays(datasets):
    tx, ty, vx, vy = datasets.load_mnist(n_train=N_TRAIN, n_valid=N_VALID)
    data = numpy.concatenate([vx.reshape(len(vx), -1),
                              tx.reshape(len(tx), -1)]).astype(
        numpy.float32)
    return data, numpy.concatenate([vy, ty]), [0, len(vx), len(tx)]


def _build(kind, max_epochs=3, seed=2468, u8=False, window=None):
    tprng.seed_all(seed)
    data, labels, lengths = _arrays(tdatasets)
    if u8:
        data = numpy.clip(data * 255.0, 0, 255).astype(numpy.uint8)

    def factory(wf):
        if kind == "full":
            ld = FullBatchLoader(wf, name="loader", minibatch_size=MB)
            ld.original_data = data.astype(numpy.float32) / 255.0 if u8 \
                else data.copy()
            ld.original_labels = labels.copy()
            ld.class_lengths = list(lengths)
            return ld
        cls = U8StreamLoader if u8 else ArrayStreamLoader
        return cls(wf, name="loader", minibatch_size=MB, data=data,
                   labels=labels, class_lengths=lengths)

    wf = StandardWorkflow(
        name="Stream_" + kind, layers=_layers(), loader_factory=factory,
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    wf.initialize(device="cpu")
    if window is not None:
        wf.step.max_window_minibatches = window
    return wf


class U8StreamLoader(ArrayStreamLoader):
    """Ships uint8, scales to [0, 1] on the device."""

    def batch_transform(self, data, train):
        return data.to(torch.float32) / 255.0


def _params(wf):
    return params_to_numpy(wf.export_tree())


def _assert_same_run(a, b):
    assert a.decision.history == b.decision.history
    pa, pb = _params(a), _params(b)
    assert sorted(pa) == sorted(pb)
    for unit in pa:
        for key in pa[unit]:
            assert numpy.array_equal(pa[unit][key], pb[unit][key]), \
                (unit, key)


@pytest.fixture
def run_closed():
    made = []
    yield made.append
    for wf in made:
        wf.close()


def test_stream_mode_selected(run_closed):
    wf = _build("stream")
    run_closed(wf)
    assert wf.loader.supports_streaming
    assert not _build("full").loader.supports_streaming
    # 32 rows of 784 float32 plus int32 labels: the 64-minibatch cap binds
    assert wf.step.window_minibatches() == 64
    wf.step.max_window_bytes = 3 * MB * (784 * 4 + 4)
    assert wf.step.window_minibatches() == 3


def test_stream_matches_fullbatch(run_closed):
    """Streamed windows == the resident gather: the same decision history
    and parameters, bit for bit, over 3 epochs."""
    full = _build("full")
    full.run()
    streamed = _build("stream")
    run_closed(streamed)
    streamed.run()
    assert len(streamed.decision.history) == 3
    _assert_same_run(full, streamed)
    assert streamed.step.train_steps == full.step.train_steps
    # valid (4 minibatches) and train (13) are one window each per epoch
    assert streamed.step.last_window_minibatches == 64
    assert len(streamed.step.stream_wait_seconds["train"]) == 3
    assert streamed.step.uploader.uploads == 6
    # padded rows travel too: 4 + 13 minibatches of 32 rows an epoch
    assert streamed.step.uploader.bytes == 3 * 17 * MB * (784 * 4 + 4)


def test_stream_small_windows_match(run_closed):
    """Window boundaries change nothing: windows of 2 and of 64
    minibatches give the same run, bit for bit."""
    a = _build("stream", window=2)
    run_closed(a)
    a.run()
    # built after a ran: the loaders share the seeded "loader" generator
    b = _build("stream", window=64)
    run_closed(b)
    b.run()
    _assert_same_run(a, b)
    # 4 + 13 minibatches in windows of 2: 2 + 7 windows an epoch
    assert a.step.uploader.uploads == 3 * 9


def test_stream_uint8_transform(run_closed):
    """uint8 windows, scaled on the device by batch_transform: the run
    equals the resident one over the same scaled floats, bit for bit."""
    full = _build("full", u8=True)
    full.run()
    wf = _build("stream", u8=True)
    run_closed(wf)
    assert wf.loader.sample_spec()["data"][1] == numpy.uint8
    wf.run()
    _assert_same_run(full, wf)
    assert wf.step.uploader.bytes == 3 * 17 * MB * (784 + 4)


def test_stop_mid_epoch_cancels_the_staged_windows(run_closed):
    """A stop ends the epoch before its next minibatch; no decision sees
    the class in flight; the staged windows are cancelled or done."""
    wf = _build("stream", window=1)
    run_closed(wf)
    seen = []
    step = wf.step

    def stop_after(cls, indices, valid, row):
        seen.append(cls)
        if len(seen) == 2:
            step.stop_requested = True
    step.after_minibatch = stop_after
    assert step.run_epoch(wf._after_decision) is False
    assert wf.decision.history == []
    assert step.train_steps == 0 and step.eval_steps == 4


def test_targets_that_are_the_data_ship_once():
    tprng.seed_all(1)
    data = numpy.arange(24, dtype=numpy.float32).reshape(6, 4)
    ld = ArrayStreamLoader(data=data, targets=data, class_lengths=[0, 2, 4],
                           minibatch_size=2)
    ld.initialize()
    assert ld.targets_are_data
    assert sorted(ld.sample_spec()) == ["data"]
    win = ld.materialize_window(2, numpy.array([[2, 3], [4, 5]]))
    assert sorted(win) == ["data"]
    numpy.testing.assert_array_equal(win["data"][1], data[4:6])


def _jax_streamed(data, labels, lengths):
    jprng.seed_all(2468)
    wf = JaxStandardWorkflow(
        None, name="JaxStream", layers=_layers(),
        loader_factory=lambda w: JaxArrayStreamLoader(
            w, name="loader", minibatch_size=MB, data=data,
            labels=labels, class_lengths=lengths),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    wf.initialize(device="cpu")
    assert wf.xla_step.stream_mode
    return wf


def test_stream_matches_the_reference(run_closed):
    """The port's streamed MNIST against the JAX package's streamed run
    from the same weights and shuffles: the same arrays, the same
    per-class error counts over 2 epochs, losses within 1e-4 and
    parameters within 1e-4 (float32 summation order)."""
    jprng.seed_all(2468)
    tprng.seed_all(2468)
    data, labels, lengths = _arrays(jdatasets)
    tdata, tlabels, _ = _arrays(tdatasets)
    assert numpy.array_equal(data, tdata)
    assert numpy.array_equal(labels, tlabels)
    jw = _jax_streamed(data, labels, lengths)
    tw = _build("stream", max_epochs=2)
    run_closed(tw)
    want = {u.name: {**u.export_params(), **u.export_state()}
            for u in jw.forwards + jw.gds}
    tw.import_tree(params_from_jax(want))
    jw.run()
    tw.run()
    got = _params(tw)
    for u in jw.forwards + jw.gds:
        for key, value in {**u.export_params(),
                           **u.export_state()}.items():
            diff = numpy.abs(numpy.asarray(value, numpy.float64)
                             - got[u.name][key]).max()
            assert diff <= 1e-4, (u.name, key, diff)
    for jh, th in zip(jw.decision.history, tw.decision.history):
        for cls in ("validation", "train"):
            assert jh[cls]["samples"] == th[cls]["samples"]
            assert round(jh[cls]["metric"] * jh[cls]["samples"]) == \
                round(th[cls]["metric"] * th[cls]["samples"]), cls
            assert abs(jh[cls]["loss"] - th[cls]["loss"]) < 1e-4
    assert len(tw.decision.history) == 2
