"""LM generation of the port (veles_torch/znicz/generate.py) against the
JAX package's (veles/znicz_tpu/generate.py), on the CPU.

The LM sample (its defaults: dim 64, 4 heads, 2 layers, vocab 16, S 32,
2048/256 sequences, 8 epochs) is trained by the port on the CPU at seed
1337; a reference workflow takes its parameters. Then: greedy KV-cached
decode equals the naive re-run of the whole training forward (argmax of
the last position); the port's greedy ``generate()`` equals the
reference's token for token; the top-k / top-p filters equal
the reference's own (its sampling closure run on the same logits); the
draws follow softmax(logits / T) (a chi-square test: torch cannot
reproduce ``jax.random``'s bits); ``n_tokens=0``; the CLI's
``--generate``."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import scipy.stats
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu import generate as jgen
from veles.znicz_tpu.models import transformer_lm as jlm
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.znicz import generate as tgen
from veles_torch.znicz.models import transformer_lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = os.path.join(REPO, "veles_torch", "znicz", "models", "transformer_lm.py")
LOADER = {"minibatch_size": 64, "n_train": 2048, "n_valid": 256,
          "seq_len": 32, "vocab": 16, "max_period": 6}
MODEL = {"dim": 64, "heads": 4, "layers": 2, "ffn_hidden": 128,
         "attn_block": None, "attn_impl": "pallas", "moe_experts": 0,
         "stacked": False}
PARALLEL = {"seq": 1, "model": 1, "data": 1, "expert": 1, "pipe": 1}
#: a chi-square test's p-value below this fails (the draws are seeded,
#: so a run either passes or fails every time)
P_MIN = 1e-3
PROMPTS = numpy.array([[1, 2, 3, 1, 2, 3, 1, 2],
                       [5, 6, 5, 6, 5, 6, 5, 6]], numpy.int32)


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
def lms():
    """(port workflow trained on cpu, reference workflow holding its
    parameters)."""
    saved = [(r, r.lm.to_dict()) for r in (jroot, troot)]
    try:
        for r in (jroot, troot):
            r.lm.loader.update(LOADER)
            r.lm.model.update(MODEL)
            r.lm.parallel.update(PARALLEL)
            r.lm.decision.update({"max_epochs": 8})
        tprng.seed_all(1337)
        tw = tlm.create_workflow(name="GenLM").initialize(device="cpu")
        tw.run()
        jprng.seed_all(1337)
        jw = jlm.create_workflow(name="GenLM")
        jw.initialize(device="numpy")
    finally:
        for r, tree in saved:
            r.lm.update(tree)
    for ju, tu in zip(jw.forwards, tw.forwards):
        assert ju.name == tu.name
        ju.import_params({k: v.numpy() for k, v in
                          tu.export_params().items()})
    return tw, jw


def naive_greedy(wf, prompt, n_tokens):
    """Re-run the port's whole training forward (eval mode) on the growing
    sequence, right-padded to the training length; argmax of the last
    real position."""
    ids = numpy.array(prompt, numpy.int32)
    seq = wf.loader.original_data.shape[1]
    out = []
    for _ in range(n_tokens):
        cur = min(ids.shape[1], seq)
        feed = numpy.pad(ids[:, -cur:], ((0, 0), (0, seq - cur)))
        _, logits = wf.step._forward(torch.from_numpy(feed), False)
        nxt = logits[:, cur - 1, :].argmax(-1).numpy().astype(numpy.int32)
        out.append(nxt)
        ids = numpy.concatenate([ids, nxt[:, None]], axis=1)
    return numpy.stack(out, axis=1)


def test_cached_decode_matches_naive(lms):
    tw, _ = lms
    got = tgen.generate(tw, PROMPTS, 6)
    assert got.shape == (2, 6) and got.dtype == numpy.int32
    numpy.testing.assert_array_equal(got, naive_greedy(tw, PROMPTS, 6))


def test_greedy_equals_reference(lms):
    """The port's greedy generate() and the reference's, same weights:
    the same tokens, also past the training length."""
    tw, jw = lms
    for n in (12, 40):
        want = jgen.generate(jw, PROMPTS, n, temperature=0.0)
        numpy.testing.assert_array_equal(tgen.generate(tw, PROMPTS, n),
                                         want)


def test_the_sample_is_trained(lms):
    """The LM sample's 8 epochs take its validation loss from 3.4 to below
    1.5 (the README's run), and its greedy continuations are not one
    repeated token."""
    tw, _ = lms
    loss = [h["validation"]["loss"] for h in tw.decision.history]
    assert loss[0] > 3.0 and loss[-1] < 1.5, loss
    assert len(set(tgen.generate(tw, PROMPTS, 12).ravel().tolist())) > 2


def _reference_sampler(jw, temperature, top_k, top_p):
    """The reference's ``sample`` closure of ``_build_fns`` (temperature,
    top_k and top_p bound in it)."""
    steps, n_caches = jgen._plan(jw)
    run = jgen._build_fns(jw, steps, n_caches, 8, temperature, 2, top_k,
                          top_p).__wrapped__
    cells = dict(zip(run.__code__.co_freevars, run.__closure__))
    return cells["sample"].cell_contents


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.6), (5, 0.3),
                                         (1, None), (None, 1e-6)])
def test_truncation_masks_equal_reference(lms, monkeypatch, top_k, top_p):
    """The logits the reference's sampler hands to
    ``jax.random.categorical`` (caught there) equal ``truncate`` of the
    port on the same logits at the same temperature."""
    _, jw = lms
    logits = numpy.random.default_rng(4).normal(0, 2, (6, 16)).astype(
        numpy.float32)
    logits[0, 3] = logits[0, 7]          # a tie at a cut
    seen = []

    def catch(key, lg, axis=-1):
        seen.append(numpy.asarray(lg))
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    sample = _reference_sampler(jw, 0.8, top_k, top_p)
    monkeypatch.setattr(jax.random, "categorical", catch)
    sample(jnp.asarray(logits), jax.random.PRNGKey(0))
    got = tgen.truncate(torch.from_numpy(logits)
                        / float(numpy.float32(0.8)), top_k, top_p)
    numpy.testing.assert_array_equal(got.numpy(), seen[0])


@pytest.mark.parametrize("top_k", [None, 4])
def test_sampling_follows_the_softmax(top_k):
    """20000 draws of one row of logits at T = 0.7: a chi-square test of
    the token counts against softmax(logits / T) (cut to the top 4,
    renormalized, with top_k 4: no draw outside it)."""
    logits = torch.from_numpy(numpy.random.default_rng(2).normal(
        0, 1, 16).astype(numpy.float32))
    gen = torch.Generator().manual_seed(7)
    n = 20000
    toks = tgen.sample(logits.expand(n, 16), 0.7, top_k=top_k,
                       generator=gen)
    counts = numpy.bincount(toks.numpy(), minlength=16)
    probs = torch.softmax(logits.double() / 0.7, -1).numpy()
    if top_k:
        keep = numpy.argsort(-probs)[:top_k]
        assert counts.sum() == counts[keep].sum()
        counts, probs = counts[keep], probs[keep] / probs[keep].sum()
    _, p = scipy.stats.chisquare(counts, probs * n)
    assert p > P_MIN, (p, counts)


def test_sampled_generation(lms):
    """temperature > 0: repeatable from one seed, inside the
    vocabulary; top_k 1 is the greedy continuation."""
    tw, _ = lms
    a = tgen.generate(tw, PROMPTS, 8, temperature=1.0, seed=7)
    b = tgen.generate(tw, PROMPTS, 8, temperature=1.0, seed=7)
    numpy.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < 16
    numpy.testing.assert_array_equal(
        tgen.generate(tw, PROMPTS, 6, temperature=1.5, top_k=1),
        tgen.generate(tw, PROMPTS, 6))


def test_edges_and_refusals(lms):
    tw, _ = lms
    assert tgen.generate(tw, PROMPTS, 0).shape == (2, 0)
    with pytest.raises(ValueError, match="prompt_ids"):
        tgen.generate(tw, [1, 2, 3], 4)
    with pytest.raises(ValueError, match="top_k"):
        tgen.generate(tw, PROMPTS, 4, temperature=1.0, top_k=-1)


def test_cli_generate(capsys):
    """``--generate 1,2,3 --gen-tokens 8`` prints the greedy continuation
    of the trained LM before the final JSON line; ``--generate-text``
    without a text corpus (before training) and a malformed prompt
    exit."""
    saved = troot.lm.to_dict()
    try:
        wf = torch_main([LM, "root.lm.loader.n_train=128",
                         "root.lm.loader.n_valid=32",
                         "root.lm.decision.max_epochs=1", "-d", "cpu",
                         "--seed", "3", "--generate", "1,2,3",
                         "--gen-tokens", "8"])
        lines = capsys.readouterr().out.strip().splitlines()
        want = tgen.generate(wf, [[1, 2, 3]], 8)[0]
        assert lines[-2] == "generated: " + ",".join(map(str, want))
        assert json.loads(lines[-1])["device"] == "cpu"
        with pytest.raises(SystemExit, match="text-corpus loader"):
            torch_main([LM, "-d", "cpu", "--generate-text", "ab"])
        with pytest.raises(SystemExit, match="comma-separated"):
            torch_main([LM, "-d", "cpu", "--generate", "1,x"])
    finally:
        troot.lm.update(copy.deepcopy(saved))
