"""The port's predict plane (veles_torch/serving: model, engine, batcher)
against the JAX package's (veles/serving), on the CPU.

Every forward op the port serves equals the reference's numpy op on the
same seeded inputs and parameters; an archive the reference wrote (MNIST,
CIFAR-10, MnistAE, the LM sample) served by the port's ``ArchiveModel``
equals the
reference's ``ArchiveModel``, both within ``OP_RTOL`` of the largest
output; an unknown type is refused when an archive is loaded. Then the
engine's bucket ladder, padding and hot swap,
and the micro-batcher's coalescing, deadlines, shedding and mixed sample
shapes, in the shape of tests/test_serving.py."""

import copy
import json
import threading
import time

import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.serving import ArchiveModel as JaxArchiveModel
from veles.serving.model import FORWARD_OPS as JAX_OPS
from veles.znicz_tpu.models import cifar10 as jcifar
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.models import mnist_ae as jmnist_ae
from veles.znicz_tpu.models import transformer_lm as jlm
from veles_torch.serving import (
    ArchiveModel, DeadlineExceeded, InferenceEngine, MicroBatcher,
    QueueFull)
from veles_torch.serving.engine import bucket_sizes
from veles_torch.serving.model import FORWARD_OPS

from tests.torch_monitor import port_model_health_isolation  # noqa: F401

#: the port's op against the reference's numpy op, as a share of the
#: largest output (f32 sums in other orders). Observed: at most 1.5e-7 for
#: an op (softmax); 3.1e-7 (MNIST), 4.7e-7 (LM) and 1.7e-6 (CIFAR-10's
#: convolutions, an im2col GEMM in numpy) for an archive
OP_RTOL = 1e-5


def _rng(seed=7):
    return numpy.random.default_rng(seed)


def _dense_case(t, transposed=False):
    r = _rng()
    w = r.normal(0, 0.3, (6, 15) if transposed else (15, 6))
    return (r.normal(0, 1, (4, 3, 5)),
            {"config": {"neurons": 6, "output_sample_shape": [6]},
             "weights_transposed": transposed},
            {"weights": w, "bias": r.normal(0, 0.1, 6)})


def _conv_case(t, padding=(1, 1, 1, 1)):
    r = _rng()
    return (r.normal(0, 1, (2, 9, 9, 3)),
            {"config": {"n_kernels": 4, "kx": 3, "ky": 3,
                        "sliding": [2, 2], "padding": list(padding)}},
            {"weights": r.normal(0, 0.3, (4, 27)),
             "bias": r.normal(0, 0.1, 4)})


def _pool_case(t):
    return (_rng().normal(0, 1, (2, 7, 7, 3)),
            {"config": {"kx": 3, "ky": 3, "sliding": [2, 2]}}, {})


def _seq_case(t):
    r = _rng()
    d, cfg, p = 8, {}, {}
    if t == "layernorm":
        cfg = {"eps": 1e-5}
        p = {"weights": 1 + r.normal(0, 0.1, d), "bias": r.normal(0, .1, d)}
    elif t.startswith("token_dense"):
        cfg = {"output_features": 6}
        p = {"weights": r.normal(0, 0.3, (d, 6)), "bias": r.normal(0, .1, 6)}
    elif t == "transformer_ffn":
        cfg = {"hidden": 16, "residual": True}
        p = {"weights": r.normal(0, .3, (d, 16)), "bias": r.normal(0, .1, 16),
             "weights2": r.normal(0, .3, (16, d)), "bias2": r.normal(0, .1, d)}
    return r.normal(0, 1, (2, 5, d)), {"config": cfg}, p


def _attention_case(t, causal=True):
    r = _rng()
    return (r.normal(0, 1, (2, 5, 8)),
            {"config": {"heads": 2, "causal": causal, "residual": True,
                        "include_bias": True}},
            {"weights": r.normal(0, 0.3, (8, 24)),
             "bias": r.normal(0, 0.1, 24),
             "weights_out": r.normal(0, 0.3, (8, 8)),
             "bias_out": r.normal(0, 0.1, 8)})


def _stack_case(t, causal=True):
    """Two stacked blocks of dim 8, 2 heads, hidden 16."""
    r = _rng()
    n, d, h = 2, 8, 16
    shapes = {"weights": (n, d, 3 * d), "bias": (n, 3 * d),
              "weights_out": (n, d, d), "bias_out": (n, d),
              "ln1_g": (n, d), "ln1_b": (n, d), "ffn_w1": (n, d, h),
              "ffn_b1": (n, h), "ffn_w2": (n, h, d), "ffn_b2": (n, d),
              "ln2_g": (n, d), "ln2_b": (n, d)}
    p = {k: (1.0 if k.endswith("_g") else 0.0) + r.normal(0, 0.3, s)
         for k, s in shapes.items()}
    return (r.normal(0, 1, (2, 5, d)),
            {"config": {"layers": n, "heads": 2, "hidden": h,
                        "causal": causal, "eps": 1e-5}}, p)


def _moe_case(t, capacity_factor=2.0, residual=True):
    """4 experts of hidden 16 over 3 samples of 6 tokens (dim 8); at a
    capacity factor of 0.5 each sample drops tokens."""
    r = _rng()
    e, d, h = 4, 8, 16
    return (r.normal(0, 1, (3, 6, d)),
            {"config": {"experts": e, "hidden": h, "residual": residual,
                        "capacity_factor": capacity_factor}},
            {"weights": r.normal(0, 0.3, (e, d, h)),
             "bias": r.normal(0, 0.1, (e, h)),
             "weights2": r.normal(0, 0.3, (e, h, d)),
             "bias2": r.normal(0, 0.1, (e, d)),
             "router": r.normal(0, 1, (d, e))})


def _deconv_case(t, sliding=(2, 2), padding=(0, 0, 0, 0),
                 out_shape=(8, 7, 2)):
    """Input (2, 4, 3, 3) through 3 kernels of 2×3 (ky, kx) onto
    ``out_shape``."""
    r = _rng()
    return (r.normal(0, 1, (2, 4, 3, 3)),
            {"config": {"n_kernels": 3, "kx": 3, "ky": 2,
                        "sliding": list(sliding), "padding": list(padding),
                        "out_shape": list(out_shape)}},
            {"weights": r.normal(0, 1, (3, 2 * 3 * out_shape[2]))})


def _depooling_case(t, k=2, sliding=(2, 2), out_shape=(8, 6, 3)):
    return (_rng().normal(0, 1, (2, 4, 3, 3)),
            {"config": {"kx": k, "ky": k, "sliding": list(sliding),
                        "out_shape": list(out_shape)}}, {})


def _embedding_case(t):
    r = _rng()
    return (r.integers(0, 10, (3, 6)).astype(numpy.float64),
            {"config": {"vocab_size": 10, "dim": 8}},
            {"weights": r.normal(0, 1, (10, 8)),
             "positions": r.normal(0, 1, (16, 8))})


OP_CASES = {
    **{t: (_dense_case, {}) for t in ("all2all", "all2all_tanh",
                                      "all2all_relu", "all2all_str",
                                      "all2all_sigmoid", "softmax")},
    "all2all[transposed]": (_dense_case, {"transposed": True}),
    **{t: (_conv_case, {}) for t in ("conv", "conv_tanh", "conv_relu",
                                     "conv_str", "conv_sigmoid")},
    "conv[unequal padding]": (_conv_case, {"padding": (1, 0, 2, 1)}),
    "max_pooling": (_pool_case, {}),
    "avg_pooling": (_pool_case, {}),
    "deconv": (_deconv_case, {}),
    "deconv[strided, unequal padding]": (
        _deconv_case, {"sliding": (2, 3), "padding": (1, 0, 2, 1),
                       "out_shape": (7, 6, 2)}),
    "depooling": (_depooling_case, {}),
    "depooling[overlapping, cropped]": (
        _depooling_case, {"k": 3, "out_shape": (8, 6, 3)}),
    "norm": (lambda t: (_rng().normal(0, 2, (2, 4, 4, 8)),
                        {"config": {"alpha": 1e-3, "beta": 0.75, "n": 5,
                                    "k": 2.0}}, {}), {}),
    "norm[beta 0.5]": (lambda t: (_rng().normal(0, 2, (2, 4, 4, 8)),
                                  {"config": {"alpha": 1e-3, "beta": 0.5,
                                              "n": 3, "k": 1.0}}, {}), {}),
    **{t: (_pool_case, {}) for t in ("dropout", "activation_tanh",
                                     "activation_relu", "activation_str",
                                     "activation_sigmoid")},
    "embedding": (_embedding_case, {}),
    **{t: (_seq_case, {}) for t in ("layernorm", "token_dense",
                                    "token_dense_relu", "transformer_ffn")},
    "attention": (_attention_case, {}),
    "attention[non-causal]": (_attention_case, {"causal": False}),
    "transformer_stack": (_stack_case, {}),
    "transformer_stack[non-causal]": (_stack_case, {"causal": False}),
    "moe_ffn": (_moe_case, {}),
    "moe_ffn[drops, no residual]": (_moe_case, {"capacity_factor": 0.5,
                                                "residual": False}),
}


def test_every_served_type_has_a_case():
    assert {c.split("[")[0] for c in OP_CASES} == set(FORWARD_OPS)
    assert set(FORWARD_OPS) == set(JAX_OPS)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_forward_op_matches_reference(case):
    t = case.split("[")[0]
    make, kwargs = OP_CASES[case]
    x, spec, p = make(t, **kwargs)
    spec = dict(spec, type=t, name="u")
    x = x.astype(numpy.float32)
    p = {k: v.astype(numpy.float32) for k, v in p.items()}
    want = JAX_OPS[t](numpy, x, p, spec)
    got = FORWARD_OPS[t](torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         spec)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = numpy.abs(got.numpy() - want).max()
    assert diff <= OP_RTOL * numpy.abs(want).max(), diff


# -- archives the reference writes ------------------------------------------

SAMPLES = {
    "mnist": (jmnist, "mnist", {"loader": {"minibatch_size": 25,
                                           "n_train": 100, "n_valid": 25}}),
    "cifar10": (jcifar, "cifar", {"loader": {"minibatch_size": 25,
                                             "n_train": 50, "n_valid": 25}}),
    "mnist_ae": (jmnist_ae, "mnist_ae",
                 {"loader": {"minibatch_size": 25, "n_train": 50,
                             "n_valid": 25}}),
    "lm": (jlm, "lm", {"loader": {"minibatch_size": 16, "n_train": 64,
                                  "n_valid": 16, "seq_len": 32,
                                  "vocab": 16, "max_period": 6},
                       "model": {"dim": 64, "heads": 4, "layers": 2,
                                 "ffn_hidden": 128, "attn_block": None,
                                 "attn_impl": None, "moe_experts": 0,
                                 "stacked": False},
                       "parallel": {"seq": 1, "model": 1, "data": 1,
                                    "expert": 1, "pipe": 1}}),
}


@pytest.fixture
def configs():
    saved = [(k, copy.deepcopy(getattr(jroot, k).to_dict()))
             for k in ("mnist", "cifar", "lm", "mnist_ae")]
    yield
    for k, tree in saved:
        getattr(jroot, k).update(tree)


def reference_archive(sample, path, seed=99):
    """A reference workflow of ``sample`` exported to ``path``; -> rows of
    its data."""
    mod, key, overrides = SAMPLES[sample]
    for sub, values in overrides.items():
        getattr(getattr(jroot, key), sub).update(values)
    jprng.seed_all(seed)
    wf = mod.create_workflow(name="Serve_" + sample)
    wf.initialize(device="numpy")
    wf.export_inference(str(path))
    return numpy.asarray(wf.loader.original_data.mem[:8], numpy.float32)


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_port_serves_reference_archive(configs, tmp_path, sample):
    rows = reference_archive(sample, tmp_path)
    want = JaxArchiveModel.from_dir(str(tmp_path))(rows)
    model = ArchiveModel.from_dir(str(tmp_path), device="cpu")
    assert model.input_sample_shape == rows.shape[1:]
    got = model(rows).numpy()
    assert numpy.abs(got - want).max() <= OP_RTOL * numpy.abs(want).max()
    jsig = JaxArchiveModel.from_dir(str(tmp_path)).signature()
    assert model.signature() == jsig


def _one_unit_archive(path, spec, arrays=None):
    for name, arr in (arrays or {}).items():
        numpy.save(path / name, arr)
    (path / "contents.json").write_text(json.dumps({
        "format": 1, "workflow": "w", "input_sample_shape": [4],
        "units": [spec]}))


def test_unknown_type_and_format_are_refused(tmp_path):
    _one_unit_archive(tmp_path, {"type": "bogus", "name": "u",
                                 "config": {}})
    with pytest.raises(ValueError, match="unknown type"):
        ArchiveModel.from_dir(str(tmp_path), device="cpu")
    (tmp_path / "contents.json").write_text(json.dumps({
        "format": 2, "units": []}))
    with pytest.raises(ValueError, match="format"):
        ArchiveModel.from_dir(str(tmp_path), device="cpu")
    # load_checkpoint is ported (tests/test_torch_resume.py); a missing
    # checkpoint file is refused
    with pytest.raises(FileNotFoundError):
        ArchiveModel("w", [4], [], {}, device="cpu").load_checkpoint(
            str(tmp_path / "missing.ckpt.npz"))


# -- engine --------------------------------------------------------------


def _mlp(tmp_path, scale=1.0, seed=3):
    r = numpy.random.default_rng(seed)
    arrays = {"fc_weights.npy": (scale * r.normal(0, 0.3, (4, 5))).astype(
        numpy.float32), "fc_bias.npy": r.normal(0, 0.1, 5).astype(
            numpy.float32)}
    _one_unit_archive(tmp_path, {
        "type": "softmax", "name": "fc",
        "config": {"neurons": 5, "output_sample_shape": [5]},
        "weights_transposed": False, "weights": "fc_weights.npy",
        "bias": "fc_bias.npy"}, arrays)
    return ArchiveModel.from_dir(str(tmp_path), device="cpu")


def test_bucket_ladder_and_padding(tmp_path):
    """Power-of-two buckets up to max_batch; a batch pads to its bucket
    with copies of its last row, which change no real row."""
    assert bucket_sizes(64) == [1, 2, 4, 8, 16, 32, 64]
    assert bucket_sizes(48) == [1, 2, 4, 8, 16, 32, 48]
    model = _mlp(tmp_path)
    eng = InferenceEngine(model, max_batch=16, device="cpu")
    assert [eng.bucket_for(n) for n in (1, 2, 3, 5, 9, 16)] == \
        [1, 2, 4, 8, 16, 16]
    with pytest.raises(ValueError, match="max_batch"):
        eng.bucket_for(17)
    assert sorted(eng.warmup()) == bucket_sizes(16)
    assert eng.compiled_buckets == bucket_sizes(16)
    rows = numpy.random.default_rng(0).normal(0, 1, (11, 4)).astype(
        numpy.float32)
    out, bucket = eng.predict(rows[:3])
    assert bucket == 4 and out.shape == (3, 5)
    alone = numpy.concatenate([eng.predict(rows[i:i + 1])[0]
                               for i in range(3)])
    assert numpy.abs(out - alone).max() <= 1e-6
    out, bucket = eng.predict(rows)
    assert bucket == 16 and out.shape == (11, 5)
    assert numpy.abs(out - model(rows).numpy()).max() <= 1e-6


def test_engine_hot_swap(tmp_path):
    """set_model swaps the weights in place: the next predict serves the
    new model; a params_only swap keeps the warm buckets."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = _mlp(tmp_path / "a")
    b = _mlp(tmp_path / "b", scale=-2.0, seed=4)
    rows = numpy.random.default_rng(1).normal(0, 1, (3, 4)).astype(
        numpy.float32)
    eng = InferenceEngine(a, max_batch=4, device="cpu")
    eng.warmup()
    before = eng.predict(rows)[0]
    assert a.signature() == b.signature()
    eng.set_model(b, params_only=True)
    assert eng.compiled_buckets == [1, 2, 4] and eng.model is b
    after = eng.predict(rows)[0]
    assert numpy.abs(after - before).max() > 1e-3
    assert numpy.abs(after - b(rows).numpy()).max() <= 1e-6
    eng.set_model(a)
    assert eng.compiled_buckets == []
    assert numpy.abs(eng.predict(rows)[0] - before).max() <= 1e-6


def test_entry_points_ask_for_a_card(tmp_path):
    model = _mlp(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ArchiveModel.from_dir(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)


# -- batcher (tests/test_serving.py's, on the port's MicroBatcher) -----------


def test_batcher_coalesces_concurrent_requests():
    calls = []

    def run_batch(rows):
        calls.append(rows.shape[0])
        time.sleep(0.005)
        return rows * 2.0, rows.shape[0]

    b = MicroBatcher(run_batch, max_batch=16, max_wait_ms=20.0)
    try:
        results = {}

        def client(i):
            results[i] = b.predict(numpy.full((1, 4), float(i),
                                              numpy.float32))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 24
        for i, out in results.items():
            numpy.testing.assert_array_equal(
                out, numpy.full((1, 4), 2.0 * i, numpy.float32))
        m = b.metrics()
        assert m["requests_total"] == 24
        assert m["batches_total"] == len(calls) < 24
        assert m["batch_fill_ratio"] > 1.0
        assert max(calls) <= 16
        assert m["latency_ms_p99"] >= m["latency_ms_p50"] > 0
    finally:
        b.close()


def test_batcher_enforces_deadlines():
    release = threading.Event()

    def slow_batch(rows):
        release.wait(timeout=5)
        return rows, rows.shape[0]

    b = MicroBatcher(slow_batch, max_batch=4, max_wait_ms=1.0)
    try:
        first = b.submit(numpy.zeros((1, 2), numpy.float32),
                         timeout_ms=5000)
        time.sleep(0.05)             # the worker is inside batch 1
        doomed = b.submit(numpy.zeros((1, 2), numpy.float32),
                          timeout_ms=10)
        time.sleep(0.05)
        release.set()
        first.event.wait(5)
        doomed.event.wait(5)
        assert first.error is None
        assert isinstance(doomed.error, DeadlineExceeded)
        assert b.metrics()["expired_total"] == 1
    finally:
        release.set()
        b.close()


def test_batcher_sheds_instead_of_queueing_unboundedly():
    release = threading.Event()

    def slow_batch(rows):
        release.wait(timeout=5)
        return rows, rows.shape[0]

    b = MicroBatcher(slow_batch, max_batch=2, max_queue=4,
                     max_wait_ms=1.0)
    try:
        b.submit(numpy.zeros((2, 2), numpy.float32))
        time.sleep(0.05)             # the worker holds the first batch
        b.submit(numpy.zeros((2, 2), numpy.float32))
        b.submit(numpy.zeros((2, 2), numpy.float32))
        with pytest.raises(QueueFull):
            b.submit(numpy.zeros((1, 2), numpy.float32))
        assert b.metrics()["shed_total"] == 1
        with pytest.raises(ValueError):
            b.submit(numpy.zeros((3, 2), numpy.float32))
        with pytest.raises(ValueError, match="timeout_ms"):
            b.submit(numpy.zeros((1, 2), numpy.float32),
                     timeout_ms=float("nan"))
    finally:
        release.set()
        b.close()


def test_batcher_groups_mixed_sample_shapes():
    def echo(rows):
        time.sleep(0.005)
        return rows + 1.0, rows.shape[0]

    b = MicroBatcher(echo, max_batch=16, max_wait_ms=20.0)
    try:
        results = {}

        def client(i):
            shape = (1, 4) if i % 2 else (1, 6)
            results[i] = (shape,
                          b.predict(numpy.zeros(shape, numpy.float32)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 10
        for shape, out in results.values():
            assert out.shape == shape
            numpy.testing.assert_array_equal(out, numpy.ones(shape))
    finally:
        b.close()


def test_batcher_over_the_engine_and_close(tmp_path):
    """The batcher drives an engine: concurrent single rows come back as
    the model's rows; after close, submit refuses."""
    model = _mlp(tmp_path)
    eng = InferenceEngine(model, max_batch=8, device="cpu")
    b = MicroBatcher(eng.predict, max_batch=8, max_wait_ms=10.0)
    rows = numpy.random.default_rng(2).normal(0, 1, (12, 4)).astype(
        numpy.float32)
    out = {}
    try:
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, b.predict(rows[i:i + 1])))
            for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        b.close()
    got = numpy.concatenate([out[i] for i in range(12)])
    assert numpy.abs(got - model(rows).numpy()).max() <= 1e-6
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(rows[:1])
