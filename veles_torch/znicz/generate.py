"""Autoregressive LM generation with a KV cache, for a trained workflow
of the port.

Counterpart of ``veles/znicz_tpu/generate.py``. It walks the trained
forward units and decodes from their parameters, in float32 on the
workflow's device:

* **prefill** — one causal forward over the prompt through the serving
  formulas (``veles_torch/serving/model.py``: the attention keeps each
  layer's K/V);
* **decode** — a Python loop over the output positions: one token's
  activations flow through the per-token formulas (embedding row +
  sinusoidal position; layernorm, FFN and token dense are sequence-free)
  and each attention layer attends its query against its K/V cache,
  a ``(B, H, maxlen, dh)`` tensor allocated once and written in place at
  each row's position (:func:`attn_decode`), with the positions past a
  row's own masked.

Greedy when ``temperature == 0`` (``torch.argmax``: the first of equal
maxima, as ``jnp.argmax``); otherwise softmax sampling, optionally cut
to the ``top_k`` largest logits and/or the ``top_p`` nucleus, drawn from
a ``torch.Generator`` made from the caller's ``seed`` (the reference's
``jax.random`` bits cannot be reproduced; sampling is held to the
distribution).

:func:`attn_decode` (defined beside the other serving formulas in
``veles_torch/serving/model.py``) takes a per-sequence position vector,
the carry the serving decode plane (``veles_torch/serving/decode.py``)
joins sequences of different lengths with; here every row sits at the
same position.

Supported units: Embedding, MultiHeadAttention (causal), LayerNorm,
TransformerFFN, MoEFFN (each sample's tokens routed on their own, as the
serving op does), TokenDense(+RELU), TransformerBlockStack (a KV cache
per inner layer, :func:`block_decode`), Dropout (identity).
"""

import numpy
import torch

from veles_torch.export_inference import unit_spec
from veles_torch.serving.model import (  # noqa: F401 (re-exported)
    FORWARD_OPS, attention_kv, attn_decode, block_decode, stack_kv)
from veles_torch.znicz.ops.attention import (
    MultiHeadAttention, TokenDenseBase, TransformerFFN)
from veles_torch.znicz.ops.dropout import DropoutForward
from veles_torch.znicz.ops.embedding import (
    EmbeddingForward, sinusoidal_positions)
from veles_torch.znicz.ops.flash_attention import MASK_VALUE
from veles_torch.znicz.ops.layernorm import LayerNormForward
from veles_torch.znicz.ops.moe import MoEFFN
from veles_torch.znicz.ops.transformer_stack import TransformerBlockStack


def _plan(workflow):
    """-> (steps, n_caches): the decode walk over the forward units, each
    step (kind, unit, first cache index), kinds ``embed``, ``attn``,
    ``stack`` (a cache per inner layer) and ``token``."""
    steps, n_caches = [], 0
    for unit in workflow.forwards:
        if isinstance(unit, EmbeddingForward):
            steps.append(("embed", unit, None))
        elif isinstance(unit, MultiHeadAttention):
            if not unit.causal:
                raise ValueError("%s: generation needs causal attention"
                                 % unit.name)
            steps.append(("attn", unit, n_caches))
            n_caches += 1
        elif isinstance(unit, TransformerBlockStack):
            if not unit.causal:
                raise ValueError("%s: generation needs causal attention"
                                 % unit.name)
            steps.append(("stack", unit, n_caches))
            n_caches += unit.layers
        elif isinstance(unit, (LayerNormForward, TransformerFFN, MoEFFN,
                               TokenDenseBase)):
            steps.append(("token", unit, None))
        elif isinstance(unit, DropoutForward):
            continue            # identity at inference
        else:
            raise ValueError("cannot generate through unit %s (%s)"
                             % (unit.name, type(unit).__name__))
    if not steps or steps[0][0] != "embed":
        raise ValueError("generation needs an embedding first")
    return steps, n_caches


def truncate(logits, top_k=None, top_p=None):
    """The reference's sampling filters on (B, V) logits: entries below
    the ``top_k``-th largest, or outside the smallest prefix of the
    sorted probabilities whose mass reaches ``top_p`` (the top entry
    always stays), become MASK_VALUE. Both cuts read one descending sort
    of the logits given."""
    if not (top_k or top_p):
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    if top_k:
        kth = srt[:, min(int(top_k), srt.shape[1]) - 1]
        logits = torch.where(logits < kth[:, None], MASK_VALUE, logits)
    if top_p:
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, MASK_VALUE, logits)
    return logits


def sample(logits, temperature, top_k=None, top_p=None, generator=None):
    """(B, V) logits -> (B,) long tokens: the argmax at temperature 0,
    else a draw from softmax(truncate(logits / temperature))."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = truncate(logits / float(numpy.float32(temperature)),
                      top_k, top_p)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def generate(workflow, prompt_ids, n_tokens, temperature=0.0, seed=0,
             top_k=None, top_p=None):
    """Generate ``n_tokens`` continuations of ``prompt_ids`` (B, P) from
    a trained LM workflow, on its device; -> int32 numpy (B, n_tokens).
    ``temperature=0`` is greedy; otherwise sampling (from a generator
    seeded with ``seed``), optionally cut to ``top_k`` and/or the
    ``top_p`` nucleus."""
    prompt_ids = numpy.asarray(prompt_ids, numpy.int32)
    if prompt_ids.ndim != 2 or prompt_ids.shape[1] < 1:
        raise ValueError("prompt_ids must be (B, P>=1)")
    n_tokens = int(n_tokens)
    if n_tokens <= 0:
        return numpy.zeros(prompt_ids.shape[:1] + (0,), numpy.int32)
    top_k = int(top_k) if top_k else None
    top_p = float(top_p) if top_p is not None and top_p < 1.0 else None
    if top_k is not None and top_k < 1:
        raise ValueError("top_k must be >= 1, got %r" % (top_k,))
    if top_p is not None and top_p <= 0:
        raise ValueError("top_p must be in (0, 1], got %r" % (top_p,))
    steps, n_caches = _plan(workflow)
    dev = workflow.device.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    b, p_len = prompt_ids.shape
    maxlen = p_len + n_tokens
    emb = steps[0][1]
    table = emb.weights.float()
    positions = torch.from_numpy(sinusoidal_positions(
        maxlen, emb.dim)).to(dev) if emb.add_positions else None
    walk = [(kind, unit_spec(unit)[0],
             {k: v.float() for k, v in unit.export_params().items()}, ci)
            for kind, unit, ci in steps[1:]]

    def draw(logits):
        return sample(logits, temperature, top_k, top_p, gen)

    with torch.no_grad():
        ids = torch.from_numpy(prompt_ids).to(dev).long()
        x = table[ids]
        if positions is not None:
            x = x + positions[:p_len]
        caches = [None] * n_caches

        def cache(ci, k, v):
            K = torch.zeros(k.shape[:2] + (maxlen, k.shape[3]),
                            dtype=torch.float32, device=dev)
            V = torch.zeros_like(K)
            K[:, :, :p_len] = k
            V[:, :, :p_len] = v
            caches[ci] = (K, V)

        for kind, spec, p, ci in walk:
            if kind == "attn":
                x, k, v = attention_kv(x, p, spec["config"])
                cache(ci, k, v)
            elif kind == "stack":
                x, kv = stack_kv(x, p, spec["config"])
                for i, (k, v) in enumerate(kv):
                    cache(ci + i, k, v)
            else:
                x = FORWARD_OPS[spec["type"]](x, p, spec)
        tok = draw(x[:, -1, :])
        out = [tok]
        pos = torch.full((b,), p_len, dtype=torch.long, device=dev)
        for _ in range(n_tokens - 1):
            x = table[tok][:, None, :]
            if positions is not None:
                x = x + positions[pos][:, None, :]
            for kind, spec, p, ci in walk:
                cfg = spec["config"]
                if kind == "attn":
                    x = attn_decode(x, pos, caches[ci], p, cfg["heads"],
                                    cfg["include_bias"], cfg["residual"])
                elif kind == "stack":
                    for i in range(cfg["layers"]):
                        x = block_decode(
                            x, pos, caches[ci + i],
                            {k: t[i] for k, t in p.items()}, cfg["heads"],
                            cfg["eps"])
                else:
                    x = FORWARD_OPS[spec["type"]](x, p, spec)
            tok = draw(x[:, 0, :])
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
