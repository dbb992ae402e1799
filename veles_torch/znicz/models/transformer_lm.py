"""Transformer-base LM sample of the PyTorch port.

Counterpart of ``veles/znicz_tpu/models/transformer_lm.py`` with the same
``root.lm`` defaults: a decoder-only LM, Embedding(+positions) →
N × [MHA(residual) → LayerNorm → FFN(residual) → LayerNorm] →
TokenDense(vocab logits), trained next-token on the deterministic
synthetic periodic-sequence corpus (the same ``"lm_data"`` draws at the
same seed). ``root.lm.model.attn_impl="pallas"`` runs attention through
the hand-written flash kernels, e.g.
``python -m veles_torch veles_torch/znicz/models/transformer_lm.py
root.lm.model.attn_impl=pallas -d cuda --seed 1337``.

Ported: the per-layer model with a dense FFN on one device. Refused
until they are ported: ``text_file`` (TextLMLoader), ``stacked``,
``moe_experts > 0`` and any ``root.lm.parallel`` axis above 1.
"""

import numpy

from veles_torch import prng
from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.ops.evaluator import EvaluatorLM
from veles_torch.znicz.standard_workflow import StandardWorkflow

root.lm.update({
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
})


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


def _refuse_unported():
    m = root.lm.model
    if root.lm.loader.get("text_file"):
        raise NotImplementedError(
            "root.lm.loader.text_file: TextLMLoader is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if m.get("stacked"):
        raise NotImplementedError(
            "root.lm.model.stacked: the fused transformer_stack (with "
            "remat) is not ported yet (ROADMAP Queue 1 item 8)")
    if m.get("moe_experts"):
        raise NotImplementedError(
            "root.lm.model.moe_experts=%r: the MoE FFN is not ported yet "
            "(ROADMAP Queue 1 item 8)" % m.moe_experts)
    par = root.lm.get("parallel")
    spec = par.to_dict() if hasattr(par, "to_dict") else dict(par or {})
    wide = {k: v for k, v in spec.items()
            if k in ("seq", "model", "data", "expert", "pipe")
            and int(v) > 1}
    if wide:
        raise NotImplementedError(
            "root.lm.parallel %s: multi-device parallelism is not ported "
            "yet (ROADMAP Queue 1 item 10)" % wide)


def build_layers():
    """The per-layer LM stack of ``root.lm`` (the reference's layer
    list, dense FFN)."""
    _refuse_unported()
    m = root.lm.model
    t = root.lm.train.to_dict()
    layers = [{"type": "embedding",
               "->": {"vocab_size": root.lm.loader.vocab, "dim": m.dim},
               "<-": dict(t)}]
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


def create_workflow(name="TransformerLM"):
    cfg = root.lm
    layers = build_layers()
    return StandardWorkflow(
        name=name, layers=layers,
        loader_factory=lambda wf: PeriodicLMLoader(
            wf, name="loader", minibatch_size=cfg.loader.minibatch_size),
        evaluator_factory=lm_evaluator_factory,
        decision_config=cfg.decision.to_dict())
