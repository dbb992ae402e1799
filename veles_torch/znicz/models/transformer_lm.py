"""Transformer-base LM sample of the PyTorch port.

Counterpart of ``veles/znicz_tpu/models/transformer_lm.py`` with the same
``root.lm`` defaults: a decoder-only LM, Embedding(+positions) →
N × [MHA(residual) → LayerNorm → FFN(residual) → LayerNorm] →
TokenDense(vocab logits), trained next-token on the deterministic
synthetic periodic-sequence corpus (the same ``"lm_data"`` draws at the
same seed), or on a UTF-8 text file at character level
(``root.lm.loader.text_file``: :class:`TextLMLoader`, the vocabulary
sized from the file before the layers are built). ``root.lm.train``
reaches every GD unit (``solver``, ``lr_policy``,
``accumulate_gradient``...). ``root.lm.model.attn_impl="pallas"`` runs
attention through the hand-written flash kernels, ``attn_block`` without
``attn_impl`` through the auto policy (the blocked scan on the CPU, the
kernels on the card from ``PALLAS_AUTO_MIN_S``); ``stacked=True`` builds
one ``transformer_stack`` unit (with ``remat``); ``moe_experts > 0``
swaps the dense FFN for the top-1 routed MoE FFN. E.g.
``python -m veles_torch veles_torch/znicz/models/transformer_lm.py
root.lm.loader.text_file=corpus.txt root.lm.train.solver=adam -d cuda
--generate-text "The "``.

``root.lm.parallel`` shards the run over ranks, one process each
(:class:`TransformerLMWorkflow`, the reference's ``_setup_parallel``):
``seq`` the ring attention, ``data`` the batch, ``model`` Megatron TP,
on one mesh over every axis above 1; the CLI spawns the ranks
(:func:`parallel_ranks`). Refused until ROADMAP Queue 1 item 10c:
``expert`` and ``pipe`` above 1, and an MoE FFN under any axis (its
capacity is a global quota that per-rank routing would change).
"""

import numpy

from veles_torch import prng
from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz import parallel
from veles_torch.znicz.ops.evaluator import EvaluatorLM
from veles_torch.znicz.standard_workflow import StandardWorkflow

#: the sample's root.lm defaults (the reference's)
DEFAULTS = {
    "loader": {"minibatch_size": 64, "n_train": 2048, "n_valid": 256,
               "seq_len": 32, "vocab": 16, "max_period": 6,
               "text_file": None, "valid_ratio": 0.1},
    "model": {"dim": 64, "heads": 4, "layers": 2, "ffn_hidden": 128,
              "attn_block": None, "attn_impl": None,
              "pallas_tile": None, "attn_pipeline": False,
              "attn_acc": None, "moe_experts": 0,
              "moe_capacity_factor": 2.0, "moe_aux_weight": 0.01,
              "stacked": False, "remat": False},
    "train": {"learning_rate": 0.05, "gradient_moment": 0.9,
              "weights_decay": 0.0},
    "decision": {"max_epochs": 8, "fail_iterations": 50},
    "parallel": {"seq": 1, "model": 1, "data": 1, "expert": 1,
                 "pipe": 1, "microbatches": 4, "ep_routing": "gather",
                 "schedule": "gpipe"},
}
root.lm.update(DEFAULTS)


def text_vocab(path, text=None):
    """Sorted character vocabulary of a text file (or of ``text`` when the
    caller already read it) -> (itos, stoi)."""
    if text is None:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
    chars = sorted(set(text))
    if not chars:
        raise ValueError("%s: empty corpus" % path)
    return chars, {c: i for i, c in enumerate(chars)}


def _tail_valid_order(n, n_valid):
    """[valid | train] index order with validation as the TAIL."""
    return numpy.concatenate([
        numpy.arange(n - n_valid, n), numpy.arange(0, n - n_valid)])


class PeriodicLMLoader(FullBatchLoader):
    """Sequences repeating a random pattern of random period ≤
    max_period; labels are the next-token shift. Token ids are served as
    int32, labels as (B, S)."""

    def load_data(self):
        cfg = root.lm.loader
        gen = prng.get("lm_data")
        n = cfg.get("n_train", 2048) + cfg.get("n_valid", 256)
        s = cfg.get("seq_len", 32)
        vocab = cfg.get("vocab", 16)
        max_p = cfg.get("max_period", 6)
        seqs = numpy.zeros((n, s + 1), numpy.int32)
        for i in range(n):
            p = int(gen.randint(2, max_p + 1))
            pattern = gen.randint(0, vocab, p)
            reps = (s + 1 + p - 1) // p
            seqs[i] = numpy.tile(pattern, reps)[:s + 1]
        n_valid = cfg.get("n_valid", 256)
        order = _tail_valid_order(n, n_valid)
        self.original_data = seqs[:, :-1][order]
        self.original_labels = seqs[:, 1:][order]
        self.class_lengths = [0, n_valid, n - n_valid]
        self.serve_dtype = numpy.int32


class TextLMLoader(FullBatchLoader):
    """Character-level corpus loader: ``root.lm.loader.text_file`` becomes
    (B, S) next-character windows, the last ``valid_ratio`` of them held
    out (at least one). The vocabulary is the one :func:`_loader_factory`
    sized the model with; a file that changed on disk since is refused."""

    def load_data(self):
        cfg = root.lm.loader
        path = cfg.text_file
        s = cfg.get("seq_len", 32)
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        cached = getattr(cfg, "_vocab_cache", None)
        if cached and cached[0] == path:
            vocab = set(cached[1])
            extra = sorted(set(text) - vocab)
            if extra:
                raise ValueError(
                    "%s changed on disk after the model was sized: %d "
                    "characters (%r...) are not in the %d-char vocabulary "
                    "the embedding was built for; restart the run"
                    % (path, len(extra), "".join(extra[:8]), len(vocab)))
            self.itos = list(cached[1])
            self.stoi = {c: i for i, c in enumerate(self.itos)}
        else:
            self.itos, self.stoi = text_vocab(path, text)
        stream = numpy.fromiter((self.stoi[c] for c in text), numpy.int32,
                                len(text))
        n = (len(stream) - 1) // s
        if n < 2:
            raise ValueError("%s: corpus too short for seq_len %d"
                             % (path, s))
        data = numpy.stack([stream[i * s:i * s + s + 1] for i in range(n)])
        n_valid = max(1, int(n * cfg.get("valid_ratio", 0.1)))
        data = data[_tail_valid_order(n, n_valid)]
        self.original_data = data[:, :-1]
        self.original_labels = data[:, 1:]
        self.class_lengths = [0, n_valid, n - n_valid]
        self.serve_dtype = numpy.int32

    def encode(self, text):
        """A prompt -> (1, len) int32 ids; characters outside the corpus
        are refused."""
        bad = sorted(set(text) - set(self.stoi))
        if bad:
            raise ValueError(
                "prompt characters %r are not in the corpus vocabulary "
                "(%d known characters)" % ("".join(bad), len(self.itos)))
        return numpy.array([[self.stoi[c] for c in text]], numpy.int32)

    def decode(self, ids):
        return "".join(self.itos[int(i)] for i in numpy.ravel(ids))


def parallel_axes():
    """{axis: size} of every ``root.lm.parallel`` axis above 1, in the
    order the mesh lays them (data, seq, model); raises
    NotImplementedError for the axes and models of ROADMAP Queue 1 item
    10c."""
    par = root.lm.get("parallel")
    spec = par.to_dict() if hasattr(par, "to_dict") else dict(par or {})
    sizes = {k: int(spec.get(k, 1)) for k in parallel.AXES}
    later = {k: sizes[k] for k in ("expert", "pipe") if sizes[k] > 1}
    if later:
        raise NotImplementedError(
            "root.lm.parallel %s: %s parallelism is not ported yet (%s)"
            % (later, " and ".join(later), parallel.LATER))
    axes = {k: sizes[k] for k in ("data", "seq", "model") if sizes[k] > 1}
    if axes and root.lm.model.get("moe_experts"):
        raise NotImplementedError(
            "root.lm.parallel %s with moe_experts=%r: the MoE capacity is "
            "a global quota that per-rank routing would change; not ported "
            "yet (%s)" % (axes, root.lm.model.moe_experts, parallel.LATER))
    return axes


def parallel_ranks():
    """The ranks ``root.lm.parallel`` asks for (1: one process)."""
    return int(numpy.prod(list(parallel_axes().values()) or [1]))


def build_layers():
    """The LM layer list of ``root.lm`` (the reference's): per-layer
    units, or one ``transformer_stack`` with ``stacked``."""
    parallel_axes()
    m = root.lm.model
    t = root.lm.train.to_dict()
    layers = [{"type": "embedding",
               "->": {"vocab_size": root.lm.loader.vocab, "dim": m.dim},
               "<-": dict(t)}]
    if m.get("stacked"):
        if m.get("moe_experts"):
            raise ValueError(
                "stacked=True builds dense-FFN blocks; it cannot honour "
                "moe_experts=%r (use the per-layer model for MoE)"
                % m.moe_experts)
        if m.get("attn_block") or m.get("attn_impl") \
                or m.get("attn_pipeline") \
                or m.get("attn_acc") not in (None, "f32"):
            raise ValueError(
                "stacked=True uses dense attention inside the block stack; "
                "attn_block=%r / attn_impl=%r / attn_pipeline=%r / "
                "attn_acc=%r are not supported there (use the per-layer "
                "model for the scan or the flash kernels)"
                % (m.get("attn_block"), m.get("attn_impl"),
                   m.get("attn_pipeline"), m.get("attn_acc")))
        return layers + [
            {"type": "transformer_stack",
             "->": {"layers": m.layers, "heads": m.heads,
                    "hidden": m.ffn_hidden, "causal": True,
                    "remat": bool(m.get("remat"))},
             "<-": dict(t)},
            {"type": "token_dense",
             "->": {"output_features": root.lm.loader.vocab},
             "<-": dict(t)}]
    if m.get("moe_experts"):
        ffn_layer = {
            "type": "moe_ffn",
            "->": {"experts": m.moe_experts, "hidden": m.ffn_hidden,
                   "residual": True,
                   "capacity_factor": m.get("moe_capacity_factor", 2.0)},
            "<-": dict(t, aux_weight=m.get("moe_aux_weight", 0.01))}
    else:
        ffn_layer = {"type": "transformer_ffn",
                     "->": {"hidden": m.ffn_hidden, "residual": True},
                     "<-": dict(t)}
    for _ in range(m.layers):
        layers += [
            {"type": "attention",
             "->": {"heads": m.heads, "causal": True, "residual": True,
                    "attn_block_size": m.get("attn_block"),
                    "attn_impl": m.get("attn_impl"),
                    "pallas_tile": m.get("pallas_tile"),
                    "attn_pipeline": m.get("attn_pipeline", False),
                    "attn_acc": m.get("attn_acc")},
             "<-": dict(t)},
            {"type": "layernorm", "<-": dict(t)},
            dict(ffn_layer),
            {"type": "layernorm", "<-": dict(t)},
        ]
    layers.append({"type": "token_dense",
                   "->": {"output_features": root.lm.loader.vocab},
                   "<-": dict(t)})
    return layers


def lm_evaluator_factory(wf):
    return EvaluatorLM(name="evaluator")


def _loader_factory():
    """The corpus: a text file (character level, its vocabulary written
    into ``root.lm.loader.vocab`` BEFORE the layers are built) or the
    synthetic periodic task."""
    cfg = root.lm.loader
    if cfg.get("text_file"):
        itos, _ = text_vocab(cfg.text_file)
        cfg.vocab = len(itos)
        cfg._vocab_cache = (cfg.text_file, "".join(itos))
        cls = TextLMLoader
    else:
        cls = PeriodicLMLoader
    return lambda wf: cls(wf, name="loader",
                          minibatch_size=cfg.minibatch_size)


class TransformerLMWorkflow(StandardWorkflow):
    """StandardWorkflow + config-driven sharding: after initialize,
    ``root.lm.parallel`` picks ring attention (seq), Megatron TP (model)
    and/or batch DP (data) on ONE mesh over every requested axis, set up
    in the reference's order. Every rank of the process group builds the
    same workflow from the same seed."""

    def initialize(self, device="cuda", with_step=True):
        out = super().initialize(device=device, with_step=with_step)
        if with_step:
            self._setup_parallel()
        return out

    def _setup_parallel(self):
        axes = parallel_axes()
        if not axes:
            return
        mesh = parallel.make_mesh(axes)
        data = axes.get("data", 1)
        if "seq" in axes:
            parallel.setup_sequence_parallel(
                self, mesh, batch_axis="data" if data > 1 else None)
        if data > 1:
            parallel.setup_data_parallel(self, mesh, refresh=False)
        if "model" in axes:
            # skips attention units already owned by the ring path
            parallel.setup_tensor_parallel(self, mesh, refresh=False)


def create_workflow(name="TransformerLM"):
    cfg = root.lm
    factory = _loader_factory()
    return TransformerLMWorkflow(
        name=name, layers=build_layers(), loader_factory=factory,
        evaluator_factory=lm_evaluator_factory,
        decision_config=cfg.decision.to_dict())
