"""The port's text-corpus LM (``TextLMLoader``, ``text_vocab``,
``_loader_factory`` in veles_torch/znicz/models/transformer_lm.py, and the
CLI's ``--generate-text``) against the JAX package's, on the CPU, with a
corpus written to ``tmp_path``."""

import contextlib
import copy
import os

import numpy
import pytest

import veles.prng as jprng
from veles.__main__ import main as jax_main
from veles.config import root as jroot
from veles.znicz_tpu.models import transformer_lm as jlm
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.znicz.models import transformer_lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LM = os.path.join(REPO, "veles", "znicz_tpu", "models",
                      "transformer_lm.py")
TORCH_LM = os.path.join(REPO, "veles_torch", "znicz", "models",
                        "transformer_lm.py")
CORPUS = "the quick brown fox jumps over the lazy dog. " * 60
#: a text LM of the reference's tests/test_text_lm.py size, trained by
#: AdamW
LOADER = {"minibatch_size": 16, "seq_len": 24, "valid_ratio": 0.1}
MODEL = {"dim": 48, "heads": 2, "layers": 2, "ffn_hidden": 96,
         "moe_experts": 0, "attn_block": None, "attn_impl": None,
         "stacked": False}
TRAIN = {"solver": "adam", "learning_rate": 0.01, "gradient_moment": 0.9,
         "weights_decay": 0.0}
PARALLEL = {"seq": 1, "model": 1, "data": 1, "expert": 1, "pipe": 1}
#: three AdamW epochs: each validation loss within this share of the
#: reference's (f32 order error through 21 updates)
EPOCHS_RTOL = 1e-5


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text(CORPUS, encoding="utf-8")
    return str(path)


@contextlib.contextmanager
def text_config(path, epochs=3):
    """The text LM's root.lm in both packages, restored after."""
    saved = [(r, copy.deepcopy(r.lm.to_dict())) for r in (jroot, troot)]
    try:
        for r in (jroot, troot):
            r.lm.loader.update(dict(LOADER, text_file=path))
            r.lm.model.update(MODEL)
            r.lm.train.update(TRAIN)
            r.lm.parallel.update(PARALLEL)
            r.lm.decision.update({"max_epochs": epochs})
        yield
    finally:
        for r, tree in saved:
            r.lm.update(tree)
            r.lm.train = tree["train"]      # drops the keys added here


def test_loader_equals_reference(corpus):
    """The vocabulary (sized into root.lm.loader.vocab before the layers
    are built), the next-character windows in [valid | train] order, the
    valid_ratio tail and the first shuffle equal the reference's."""
    with text_config(corpus):
        jprng.seed_all(5)
        jw = jlm.create_workflow(name="T")
        jw.initialize(device="cpu")
        tprng.seed_all(5)
        tw = tlm.create_workflow(name="T").initialize(device="cpu")
        assert troot.lm.loader.vocab == jroot.lm.loader.vocab == \
            len(set(CORPUS))
    jl, tl = jw.loader, tw.loader
    assert tl.itos == jl.itos == sorted(set(CORPUS))
    assert numpy.array_equal(tl.original_data, jl.original_data.mem)
    assert numpy.array_equal(tl.original_labels, jl.original_labels.mem)
    assert tl.class_lengths == list(jl.class_lengths)
    n = (len(CORPUS) - 1) // LOADER["seq_len"]
    assert tl.class_lengths[1] == int(n * LOADER["valid_ratio"])
    assert numpy.array_equal(jl.class_schedule(2)[0],
                             tl.class_schedule(2)[0])
    assert (tl.original_data[:, 1:] == tl.original_labels[:, :-1]).all()
    assert tw.forwards[0].weights.shape[0] == len(set(CORPUS))


def test_encode_decode(corpus):
    with text_config(corpus):
        tw = tlm.create_workflow().initialize(device="cpu")
    ids = tw.loader.encode("lazy fox")
    assert ids.dtype == numpy.int32 and ids.shape == (1, 8)
    assert tw.loader.decode(ids[0]) == "lazy fox"
    assert tw.loader.decode(tw.loader.original_data[0]) in CORPUS
    with pytest.raises(ValueError, match="not in the corpus"):
        tw.loader.encode("FOX!")


def test_a_corpus_changed_on_disk_is_refused(corpus):
    """The model is sized for the file it saw at build time: a character
    added to the file before the loader reads it is refused."""
    with text_config(corpus):
        wf = tlm.create_workflow()
        with open(corpus, "a", encoding="utf-8") as f:
            f.write("Zebra!")
        with pytest.raises(ValueError, match="changed on disk"):
            wf.initialize(device="cpu")


def test_short_and_empty_corpora_are_refused(tmp_path):
    short = tmp_path / "short.txt"
    short.write_text("abc")
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with text_config(str(short)):
        with pytest.raises(ValueError, match="too short"):
            tlm.create_workflow().initialize(device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tlm.text_vocab(str(empty))


def test_adam_epochs_match_reference(corpus):
    """Three AdamW epochs on the corpus from the same seed: every epoch's
    validation loss within EPOCHS_RTOL of the reference's, and falling."""
    with text_config(corpus):
        jprng.seed_all(321)
        jw = jlm.create_workflow(name="T")
        jw.initialize(device="cpu")
        jw.run()
        tprng.seed_all(321)
        tw = tlm.create_workflow(name="T").initialize(device="cpu")
        tw.run()
    jh, th = jw.decision.history, tw.decision.history
    assert len(jh) == len(th) == 3
    for j, t in zip(jh, th):
        assert abs(j["validation"]["loss"] - t["validation"]["loss"]) <= \
            EPOCHS_RTOL * j["validation"]["loss"]
    assert th[-1]["validation"]["loss"] < th[0]["validation"]["loss"]


def _generated(out):
    return [line for line in out.splitlines()
            if line.startswith("generated: ")]


def test_generate_text_equals_reference_cli(corpus, capsys):
    """The README's command on both CLIs (-d cpu, seed 321, 10 AdamW
    epochs, ``--generate-text "the " --gen-tokens 24``): the same greedy
    text, a real continuation of the corpus."""
    overrides = ["root.lm.loader.%s=%r" % kv for kv in
                 dict(LOADER, text_file=corpus).items()] + \
        ["root.lm.model.%s=%r" % kv for kv in MODEL.items()] + \
        ["root.lm.train.%s=%r" % kv for kv in TRAIN.items()] + \
        ["root.lm.decision.max_epochs=10"]
    tail = ["-d", "cpu", "--seed", "321", "--generate-text", "the ",
            "--gen-tokens", "24"]
    with text_config(corpus):
        jax_main([JAX_LM] + overrides + tail + ["--no-stats"])
        want = _generated(capsys.readouterr().out)
        torch_main([TORCH_LM] + overrides + tail)
        got = _generated(capsys.readouterr().out)
    assert len(want) == 1 and got == want
    text = got[0][len("generated: "):]
    assert len(text) == 4 + 24 and text.startswith("the ")
    assert text in CORPUS, text
    with text_config(corpus):
        with pytest.raises(SystemExit, match="not in the corpus"):
            torch_main([TORCH_LM] + overrides + ["-d", "cpu",
                                                 "--generate-text", "QQ"])
