"""The port's generative serving plane (veles_torch/serving/decode.py:
DecodePlan, KVPool, GenerativeEngine, ContinuousBatcher) on the CPU,
against the port's offline ``generate()`` and the JAX package's
``GenerativeEngine`` (veles/serving/decode.py), in the shape of
tests/test_decode.py.

The LM sample (dim 64, 2 layers, vocab 16, S 32; 2048/256 sequences,
8 epochs at seed 1337) is trained by the port and exported; both
packages decode that archive. Greedy continuous decode equals
``generate()`` token for token, also for two sequences of different
lengths sharing the decode steps, and equals the reference's
continuous decode of the same archive; requests join in flight and
leave at EOS; admission is bounded, validated, and expires queued
requests while the pool is full; the pool's bytes and slots add up."""

import json
import time

import numpy
import pytest
import torch

import veles_torch.prng as tprng
from veles.serving import ArchiveModel as JaxArchiveModel
from veles.serving import ContinuousBatcher as JaxContinuousBatcher
from veles.serving import GenerativeEngine as JaxGenerativeEngine
from veles_torch.config import root as troot
from veles_torch.serving import (
    ArchiveModel, ContinuousBatcher, DeadlineExceeded, DecodePlan,
    GenerativeEngine, QueueFull)
from veles_torch.znicz.generate import generate
from veles_torch.znicz.models import transformer_lm as tlm

LOADER = {"minibatch_size": 64, "n_train": 2048, "n_valid": 256,
          "seq_len": 32, "vocab": 16, "max_period": 6}
MODEL = {"dim": 64, "heads": 4, "layers": 2, "ffn_hidden": 128,
         "attn_block": None, "attn_impl": "pallas", "moe_experts": 0,
         "stacked": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its LM training and
    the decode worker beside the test's own thread stay light when the
    test runner shares the cores among several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_env(tmp_path_factory):
    """The trained LM sample, its archive, and one decode plane (4 slots
    of 256 positions, a queue of 2) shared by the tests."""
    saved = troot.lm.to_dict()
    try:
        troot.lm.loader.update(LOADER)
        troot.lm.model.update(MODEL)
        troot.lm.parallel.update({"seq": 1, "model": 1, "data": 1,
                                  "expert": 1, "pipe": 1})
        troot.lm.decision.update({"max_epochs": 8})
        tprng.seed_all(1337)
        wf = tlm.create_workflow(name="DecodeLM").initialize(device="cpu")
        wf.run()
    finally:
        troot.lm.update(saved)
    archive = str(tmp_path_factory.mktemp("decode") / "archive")
    wf.export_inference(archive)
    model = ArchiveModel.from_dir(archive, device="cpu")
    engine = GenerativeEngine(model, n_slots=4, max_len=256, device="cpu")
    decoder = ContinuousBatcher(engine, max_queue=2)
    yield {"wf": wf, "archive": archive, "model": model,
           "decoder": decoder}
    decoder.close()


def offline(wf, prompt, n):
    return generate(wf, [prompt], n)[0].tolist()


def test_plan_probe_and_rejection(lm_env, tmp_path):
    """Only causal-LM archives build a decode plan; a classifier archive
    is refused loudly (and probe() says so quietly)."""
    model = lm_env["model"]
    assert DecodePlan.probe(model)
    plan = DecodePlan.from_archive(model)
    assert plan.n_caches == 2 and plan.vocab == 16 and plan.dim == 64
    assert plan.cache_specs == [(4, 16), (4, 16)]
    assert plan.positions_limit(model.params) == 256
    numpy.save(tmp_path / "fc_weights.npy", numpy.zeros((4, 4),
                                                        numpy.float32))
    (tmp_path / "contents.json").write_text(json.dumps({
        "format": 1, "workflow": "clf", "input_sample_shape": [4],
        "units": [{"type": "all2all", "name": "fc",
                   "config": {"neurons": 4, "output_sample_shape": [4]},
                   "weights": "fc_weights.npy", "bias": None}]}))
    clf = ArchiveModel.from_dir(str(tmp_path), device="cpu")
    assert not DecodePlan.probe(clf)
    with pytest.raises(ValueError, match="embedding"):
        DecodePlan.from_archive(clf)


def test_decode_matches_offline_generate(lm_env):
    """Greedy continuous decode == generate(), token for token, with two
    sequences of different lengths sharing the steps; sampled decode
    stays inside the vocabulary; the slots come back."""
    wf, decoder = lm_env["wf"], lm_env["decoder"]
    assert decoder.generate([1, 2, 3, 1, 2, 3], max_tokens=8) == \
        offline(wf, [1, 2, 3, 1, 2, 3], 8)
    h1 = decoder.submit([1, 2, 3, 4, 5], max_tokens=12)
    h2 = decoder.submit([5, 6, 5], max_tokens=6)
    assert h1.wait(120) == offline(wf, [1, 2, 3, 4, 5], 12)
    assert h2.wait(120) == offline(wf, [5, 6, 5], 6)
    assert h1.finish_reason == h2.finish_reason == "length"
    assert decoder.engine.pool.in_use == 0
    sampled = decoder.generate([1, 2, 3], max_tokens=8, temperature=1.0)
    assert len(sampled) == 8 and all(0 <= t < 16 for t in sampled)


def test_greedy_equals_reference_decode(lm_env):
    """The reference's GenerativeEngine + ContinuousBatcher on the same
    archive give the same greedy tokens, for concurrent prompts of
    different lengths."""
    ref = JaxContinuousBatcher(JaxGenerativeEngine(
        JaxArchiveModel.from_dir(lm_env["archive"]), n_slots=4,
        max_len=256), model="ref")
    prompts = ([1, 2, 3, 4, 5], [5, 6, 5], [7, 8, 9, 7, 8, 9, 7, 8, 9, 7])
    try:
        want = [h.wait(300) for h in [ref.submit(p, max_tokens=20)
                                      for p in prompts]]
    finally:
        ref.close()
    port = ContinuousBatcher(GenerativeEngine(
        lm_env["model"], n_slots=4, max_len=256, device="cpu"))
    try:
        got = [h.wait(120) for h in [port.submit(p, max_tokens=20)
                                     for p in prompts]]
    finally:
        port.close()
    assert got == want


def test_midflight_admission_eos_and_sharing(lm_env):
    """A request submitted while another decodes joins the in-flight
    batch, and an EOS frees its slot mid-flight without disturbing its
    neighbour."""
    wf, decoder = lm_env["wf"], lm_env["decoder"]
    steps0 = decoder.counts["steps_total"]
    long = decoder.submit([1, 2, 3, 4], max_tokens=60)
    deadline = time.time() + 30
    while time.time() < deadline and len(long.tokens) < 3:
        time.sleep(0.005)
    assert len(long.tokens) >= 3
    want_short = offline(wf, [5, 6, 5, 6], 30)
    eos = want_short[2]
    short = decoder.submit([5, 6, 5, 6], max_tokens=30, eos=eos)
    got_short = short.wait(120)
    assert short.finish_reason == "eos"
    assert got_short == want_short[:got_short.index(eos) + 1]
    assert got_short[-1] == eos and len(got_short) <= 3
    assert long.wait(120) == offline(wf, [1, 2, 3, 4], 60)
    assert decoder.counts["steps_total"] - steps0 < 60 + len(got_short)
    assert decoder.engine.pool.in_use == 0


def _saturate(decoder, n):
    held = []
    for _ in range(n):
        h = decoder.submit([1, 2, 3], max_tokens=250)
        held.append(h)
        deadline = time.time() + 30
        while time.time() < deadline and not h.tokens:
            time.sleep(0.005)
        assert h.tokens
    return held


def _release(decoder, held):
    for h in held:
        h.cancel("test cleanup")
    for h in held:
        h.wait(120)
    deadline = time.time() + 10
    while time.time() < deadline and decoder.engine.pool.in_use:
        time.sleep(0.01)
    assert decoder.engine.pool.in_use == 0


def test_decode_shedding_and_validation(lm_env):
    """With every slot busy and the queue at max_queue the next submit
    sheds; geometry and number violations are refused before any slot is
    touched."""
    decoder = lm_env["decoder"]
    with pytest.raises(ValueError, match="KV slot"):
        decoder.submit([1] * 8, max_tokens=1000)
    with pytest.raises(ValueError):
        decoder.submit([], max_tokens=4)
    for bad in (float("nan"), float("inf"), -5):
        with pytest.raises(ValueError, match="timeout_ms"):
            decoder.submit([1], timeout_ms=bad)
    with pytest.raises(ValueError, match="max_tokens"):
        decoder.submit([1], max_tokens=float("inf"))
    shed0 = decoder.counts["shed_total"]
    held = _saturate(decoder, 4)
    try:
        with pytest.raises(QueueFull):
            for _ in range(4):
                held.append(decoder.submit([1, 2], max_tokens=250))
        assert decoder.counts["shed_total"] == shed0 + 1
    finally:
        _release(decoder, held)


def test_queued_request_expires_while_pool_saturated(lm_env):
    decoder = lm_env["decoder"]
    held = _saturate(decoder, 4)
    try:
        doomed = decoder.submit([1, 2], max_tokens=5, timeout_ms=40)
        with pytest.raises(DeadlineExceeded):
            doomed.wait(15)
        assert decoder.engine.pool.in_use == 4
        assert decoder.counts["expired_total"] >= 1
    finally:
        _release(decoder, held)


def test_step_logits_match_full_forward(lm_env):
    """The decode step's logits for a slot equal the archive's full
    forward over prompt + token at its last position (f32 both, within
    1e-5 of the largest logit): the slot's K/V row, its position and the
    mask are right, beside another slot at another position."""
    model = lm_env["model"]
    engine = GenerativeEngine(model, n_slots=3, max_len=64, device="cpu")
    prompts = ([1, 2, 3, 1, 2], [6, 5, 4, 6, 5, 4, 6, 5, 4, 6, 5])
    toks = numpy.zeros(3, numpy.int32)
    pos = numpy.zeros(3, numpy.int32)
    for slot, p in zip((2, 0), prompts):
        toks[slot] = engine.prefill_into(slot, p, 0.0)
        pos[slot] = len(p)
    logits = engine.logits(toks, pos)
    for slot, p in zip((2, 0), prompts):
        full = model([p + [int(toks[slot])]])[0, -1]
        assert (logits[slot] - full).abs().max() <= \
            1e-5 * full.abs().max()


def test_kv_pool_accounting_and_metrics(lm_env):
    """The pool holds 2 layers × (K + V) × slots × heads × max_len × dh f32
    values; max_len is clamped to the exported positions table; the
    metrics add up; warmup runs every bucket."""
    engine = GenerativeEngine(lm_env["model"], n_slots=2, max_len=1000,
                              device="cpu")
    assert engine.max_len == 256
    assert engine.pool.nbytes() == 2 * 2 * 2 * 4 * 256 * 16 * 4
    assert [engine.prompt_bucket(n) for n in (1, 3, 17, 256)] == \
        [1, 4, 32, 256]
    with pytest.raises(ValueError, match="max_len"):
        engine.prompt_bucket(257)
    assert "step" in engine.warmup([1, 8])
    assert engine.compiled_buckets == [1, 8]
    batcher = ContinuousBatcher(engine)
    try:
        batcher.generate([3, 4, 5], max_tokens=5)
        m = batcher.metrics()
        assert m["kv_pool_slots"] == 2 and m["kv_slots_in_use"] == 0
        assert m["kv_pool_bytes"] == engine.pool.nbytes()
        assert m["generated_tokens_total"] == 5 and m["steps_total"] == 4
        assert m["first_token_ms_p99"] >= m["first_token_ms_p50"] > 0
        assert batcher.healthy() == (True, None)
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit([1], max_tokens=1)
    assert batcher.healthy() == (True, None)


def test_close_fails_queued_and_inflight(lm_env):
    engine = GenerativeEngine(lm_env["model"], n_slots=1, max_len=256,
                              device="cpu")
    batcher = ContinuousBatcher(engine)
    running = batcher.submit([1, 2, 3], max_tokens=250)
    queued = batcher.submit([4, 5], max_tokens=5)
    deadline = time.time() + 30
    while time.time() < deadline and not running.tokens:
        time.sleep(0.005)
    batcher.close()
    for h in (running, queued):
        with pytest.raises(RuntimeError, match="closed"):
            h.wait(30)
    assert engine.pool.in_use == 0
