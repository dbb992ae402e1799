"""At-rest weight quantization of the port (veles_torch/serving/quant.py)
against the JAX package's (veles/serving/quant.py), on the CPU.

The int8 payload, scale and zero point equal the reference's bit for bit
and the fp8 payload equals the ``ml_dtypes`` cast bit for bit; the
round-trip bounds, the eligibility policy, the quantized forward's
parity against f32 and the at-rest bytes are those of
tests/test_wquant.py; a quantized forward equals the reference's
quantized forward; ``gather_rows`` dequantizes only the rows it
gathers; a quantized decode keeps the f32 decode's greedy tokens where
f32 has a real margin."""

import copy

import ml_dtypes
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.serving import quant as jquant
from veles.serving.engine import InferenceEngine as JaxInferenceEngine
from veles.serving.model import ArchiveModel as JaxArchiveModel
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.models import transformer_lm as jlm
from veles_torch.serving import (
    ArchiveModel, ContinuousBatcher, GenerativeEngine, InferenceEngine)
from veles_torch.serving import quant
from veles_torch.serving.quant import (
    MODES, QuantizedTensor, dense_params, gather_rows, quantize_tensor,
    quantize_tree, tree_nbytes)

#: the reference's bounds (tests/test_wquant.py): post-softmax outputs of
#: a quantized forward against f32, and at-rest bytes against f32
PARITY_ATOL = 2e-2
BYTES_RATIO = 0.55
#: the port's quantized forward against the reference's on the same
#: archive (the same payloads, f32 sums in other orders). Observed:
#: 2.1e-7 (int8), 2.4e-7 (fp8)
QUANT_FWD_ATOL = 1e-6


def _tensors():
    rng = numpy.random.default_rng(11)
    return {"normal": rng.normal(0, 0.3, (64, 48)),
            "skewed": rng.exponential(1.0, (40, 33)) - 0.2,
            "wide": rng.normal(0, 30.0, (17, 100)),
            "constant": numpy.full((40, 40), 3.25),
            "tiny": rng.normal(0, 1e-6, (32, 32))}


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_int8_payload_scale_zero_bitwise(name):
    w = _tensors()[name].astype(numpy.float32)
    want = jquant.quantize_tensor(w, "int8")
    got = quantize_tensor(torch.from_numpy(w), "int8")
    assert got.q.dtype == torch.uint8
    numpy.testing.assert_array_equal(got.q.numpy(), want.q)
    assert got.scale.numpy().tobytes() == want.scale.tobytes()
    assert got.zero.numpy().tobytes() == want.zero.tobytes()
    numpy.testing.assert_array_equal(got.dense().numpy(),
                                     want.dense(numpy))


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_fp8_payload_equals_ml_dtypes_cast(name):
    w = _tensors()[name].astype(numpy.float32)
    want = jquant.quantize_tensor(w, "fp8")
    got = quantize_tensor(torch.from_numpy(w), "fp8")
    assert got.q.dtype == torch.float8_e4m3fn
    assert want.q.dtype == ml_dtypes.float8_e4m3fn
    numpy.testing.assert_array_equal(got.q.view(torch.uint8).numpy(),
                                     want.q.view(numpy.uint8))
    assert got.scale.numpy().tobytes() == want.scale.tobytes()
    numpy.testing.assert_array_equal(got.dense().numpy(),
                                     want.dense(numpy))


@pytest.mark.parametrize("mode", ("int8", "fp8"))
def test_round_trip_error_bounds(mode):
    w = numpy.random.default_rng(11).normal(0, 0.3, (64, 48)).astype(
        numpy.float32)
    qt = quantize_tensor(torch.from_numpy(w), mode)
    assert qt.shape == w.shape
    assert qt.nbytes < w.nbytes / 3.5
    back = qt.dense().numpy()
    if mode == "int8":
        assert numpy.abs(back - w).max() <= (w.max() - w.min()) / 255 * 0.51
    else:
        rel = numpy.abs(back - w) / numpy.maximum(numpy.abs(w), 1e-3)
        assert rel.max() < 0.08, rel.max()


def test_constant_and_mode_edges():
    w = torch.full((40, 40), 3.25)
    for mode in ("int8", "fp8"):
        assert torch.allclose(quantize_tensor(w, mode).dense(), w,
                              rtol=1e-2)
    qt = quantize_tensor(w, "int8")
    assert quantize_tensor(qt, "int8") is qt
    assert quantize_tensor(qt, "fp8").mode == "fp8"
    with pytest.raises(ValueError):
        quantize_tensor(w, "int4")
    with pytest.raises(ValueError):
        InferenceEngine(None, quantize="fp16", device="cpu")
    assert MODES == ("none", "int8", "fp8") == jquant.MODES


def test_tree_policy_skips_vectors():
    tree = {"fc": {"weights": torch.zeros((64, 64)),
                   "bias": torch.zeros(64), "small": torch.zeros((4, 4))}}
    q = quantize_tree(tree, "int8")
    assert isinstance(q["fc"]["weights"], QuantizedTensor)
    assert not isinstance(q["fc"]["bias"], QuantizedTensor)
    assert not isinstance(q["fc"]["small"], QuantizedTensor)
    assert quantize_tree(tree, "none") is tree
    with pytest.raises(ValueError):
        quantize_tree(tree, "bf16")
    dense = dense_params(q["fc"])
    assert all(torch.is_tensor(v) for v in dense.values())
    assert dense_params(tree["fc"]) is tree["fc"]
    assert tree_nbytes(q) == 64 * 64 + 8 + 64 * 4 + 16 * 4


def test_gather_rows_dequantizes_only_the_gathered_rows(monkeypatch):
    w = torch.from_numpy(numpy.random.default_rng(5).normal(
        0, 1, (1000, 16)).astype(numpy.float32))
    qt = quantize_tensor(w, "int8")
    seen = []
    dense = QuantizedTensor.dense

    def spy(self, payload=None):
        seen.append(tuple((self.q if payload is None else payload).shape))
        return dense(self, payload)

    monkeypatch.setattr(QuantizedTensor, "dense", spy)
    idx = torch.tensor([[3, 999], [0, 3]])
    got = gather_rows(qt, idx)
    assert seen == [(2, 2, 16)]
    assert torch.equal(got, dense(qt)[idx])
    assert torch.equal(gather_rows(w, idx), w[idx])
    assert gather_rows(qt, slice(None, 5)).shape == (5, 16)


@pytest.fixture
def configs():
    saved = [(k, copy.deepcopy(getattr(jroot, k).to_dict()))
             for k in ("mnist", "lm")]
    yield
    for k, tree in saved:
        getattr(jroot, k).update(tree)


@pytest.fixture
def mlp_archive(configs, tmp_path):
    """The untrained MNIST MLP archive of tests/test_wquant.py (written
    by the reference) and 16 of its rows."""
    jroot.mnist.loader.update({"minibatch_size": 25, "n_train": 100,
                               "n_valid": 25})
    jprng.seed_all(424)
    wf = jmnist.create_workflow(name="WQuantMLP")
    wf.initialize(device="numpy")
    wf.export_inference(str(tmp_path))
    return str(tmp_path), numpy.asarray(wf.loader.original_data.mem[:16],
                                        numpy.float32)


@pytest.mark.parametrize("mode", ("int8", "fp8"))
def test_forward_parity_and_at_rest_bytes(mlp_archive, mode):
    """Quantized outputs within PARITY_ATOL of f32, top-1 equal wherever
    f32 has a real margin, the at-rest bytes at most BYTES_RATIO of f32;
    and the port's quantized forward equals the reference's."""
    path, x = mlp_archive
    out, nbytes = {}, {}
    for m in ("none", mode):
        model = ArchiveModel.from_dir(path, device="cpu")
        eng = InferenceEngine(model, max_batch=16, quantize=m, device="cpu")
        out[m] = eng.predict(x)[0]
        nbytes[m] = tree_nbytes(eng.params)
    diff = numpy.abs(out[mode] - out["none"]).max()
    assert diff < PARITY_ATOL, diff
    top2 = numpy.sort(out["none"], axis=1)[:, -2:]
    strong = top2[:, 1] - top2[:, 0] > 2 * diff
    assert strong.any()
    agree = out[mode].argmax(1) == out["none"].argmax(1)
    assert agree[strong].all()
    assert nbytes[mode] / nbytes["none"] <= BYTES_RATIO
    ref = JaxInferenceEngine(JaxArchiveModel.from_dir(path), backend="numpy",
                             max_batch=16, quantize=mode)
    want = ref.predict(x)[0]
    assert numpy.abs(out[mode] - want).max() <= QUANT_FWD_ATOL


def test_quantized_decode_keeps_greedy_tokens(configs, tmp_path):
    """int8 decode through the continuous batcher keeps the f32 decode's
    greedy tokens along the prefix where f32 has a real top-2 margin
    (the reference's gate, tests/test_wquant.py); the at-rest bytes
    shrink."""
    jroot.lm.loader.update({"minibatch_size": 8, "n_train": 64,
                            "n_valid": 16, "seq_len": 16, "vocab": 32,
                            "max_period": 8})
    jroot.lm.model.update({"dim": 64, "heads": 4, "layers": 2,
                           "ffn_hidden": 128, "moe_experts": 0,
                           "attn_block": None, "attn_impl": None,
                           "stacked": False})
    jroot.lm.parallel.update({"seq": 1, "model": 1, "data": 1, "expert": 1,
                              "pipe": 1})
    jprng.seed_all(99)
    wf = jlm.create_workflow(name="WQuantLM")
    wf.initialize(device="numpy")
    wf.export_inference(str(tmp_path))
    prompt, n_new = [1, 2, 3], 8
    toks, logits, nbytes = {}, {}, {}
    for mode in ("none", "int8"):
        model = ArchiveModel.from_dir(str(tmp_path), device="cpu")
        model.params = quantize_tree(model.params, mode)
        nbytes[mode] = tree_nbytes(model.params)
        batcher = ContinuousBatcher(GenerativeEngine(
            model, n_slots=2, max_len=32, device="cpu"))
        try:
            toks[mode] = batcher.generate(prompt, max_tokens=n_new)
        finally:
            batcher.close()
        chain = prompt + toks["none"]
        rows = [chain[:len(prompt) + i] + [0] * (16 - len(prompt) - i)
                for i in range(n_new)]
        y = model(numpy.asarray(rows, numpy.float32)).numpy()
        logits[mode] = numpy.stack([y[i, len(prompt) + i - 1]
                                    for i in range(n_new)])
    assert nbytes["int8"] < nbytes["none"]
    diff = numpy.abs(logits["int8"] - logits["none"]).max()
    top2 = numpy.sort(logits["none"], axis=1)[:, -2:]
    strong = top2[:, 1] - top2[:, 0] > 2 * diff + 1e-3
    assert strong.any(), (top2, diff)
    for i in range(n_new):
        if not strong[i]:
            break
        assert toks["int8"][i] == toks["none"][i], (i, toks)


def test_quantized_tensor_moves_with_its_scalars():
    """``to`` moves the payload and both scalars (the engines' upload)."""
    qt = quant.quantize_tensor(torch.ones((32, 32)), "int8").to("cpu")
    assert qt.device.type == "cpu" and qt.ndim == 2
    assert qt.scale.device == qt.zero.device == qt.q.device
