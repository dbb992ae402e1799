"""The benchmark's yardstick: the work a model needs, and the card's peaks.

Everything here is computed from a configuration's shapes, never read
from the program, so a change that does less work cannot make the work
look smaller. The language-model count is ``bench.py``'s
``lm_train_flops_per_token`` (its ``LM_ROWS`` arithmetic), copied; the
peak table is ``veles_torch/perf.py``'s, copied. Neither copy follows
later edits of its source.
"""

#: dense peak FLOP/s of one card by a substring of its name (NVIDIA's H100
#: SXM data sheet, without sparsity), and its HBM bandwidth in bytes/s
PEAKS = (
    ("H100", {"bf16": 989.4e12, "fp8": 1978.9e12, "tf32": 494.7e12,
              "f32": 66.9e12, "hbm_bytes_per_s": 3.35e12}),
)

#: bytes of one element of an activation under the bf16 policy
BF16 = 2
F32 = 4


def peaks(device_name):
    """The peak table row of the card named ``device_name``; raises for a
    card the table does not hold (a share of an unknown peak is no
    number)."""
    for sub, row in PEAKS:
        if sub in device_name:
            return row
    raise KeyError("no peak table row for %r" % device_name)


def roofline_seconds(flops, nbytes, row, precision="bf16"):
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / row[precision], nbytes / row["hbm_bytes_per_s"])


# -- the language model ------------------------------------------------------


def lm_train_flops_per_token(dim, layers, ffn_hidden, vocab, seq):
    """Train FLOPs per token of the causal LM (``bench.py``, copied):

    * matmul parameters: 6 FLOPs each (2 forward + 4 backward) over the
      qkv, out, FFN and vocabulary-head weights; the embedding lookup is a
      gather and counts nothing;
    * attention scores and context over the causal pairs: per layer per
      sequence 6·S(S+1)·dim, so 6·(S+1)·dim per token per layer. The
      masked half is not counted: a perfect implementation skips it."""
    n_mm = layers * (4 * dim * dim + 2 * dim * ffn_hidden) + dim * vocab
    return 6.0 * n_mm + 6.0 * layers * (seq + 1) * dim


def lm_shape(model, traffic):
    """(dim, heads, layers, ffn, vocab, batch, seq) of a configuration's
    ``model`` section (the published key names) and a traffic mix."""
    return (int(model["hidden_size"]), int(model["num_attention_heads"]),
            int(model["num_hidden_layers"]),
            int(model["intermediate_size"]), int(model["vocab_size"]),
            int(traffic["minibatch_size"]), int(traffic["seq_len"]))


def lm_step_flops(model, traffic):
    """Train FLOPs of one full minibatch of the LM."""
    dim, _, layers, ffn, vocab, b, s = lm_shape(model, traffic)
    return lm_train_flops_per_token(dim, layers, ffn, vocab, s) * b * s


def lm_attention_step_work(model, traffic):
    """(FLOPs, bytes) one train step needs of the attention units: the qkv
    and out projections (6 FLOPs a weight a token) and the causal core
    (6·(S+1)·dim a token), every layer; bytes: each unit's bf16 input
    read and output written, forward and backward, its f32 weights read
    and written by the update, and the f32 qkv, out and bias gradients
    written once."""
    dim, _, layers, _, _, b, s = lm_shape(model, traffic)
    tokens = b * s
    flops = layers * tokens * (6.0 * 4 * dim * dim + 6.0 * (s + 1) * dim)
    weights = 4 * dim * dim + 4 * dim
    per_layer = (4 * tokens * dim * BF16           # x in, y out, err in, out
                 + 3 * weights * F32)              # read, write, grad
    return flops, layers * per_layer


# -- AlexNet ---------------------------------------------------------------


def alexnet_layers(model):
    """[(kind, name, dict)] of the one-tower AlexNet of ``model``: each
    conv and FC with its output shape (oy, ox, channels) and
    multiply-accumulates per image, each pool with its output shape.
    Pools are ceil-mode (the port's and the reference's rule)."""
    h, w = model["crop"]
    c = 3
    out = []
    for i, conv in enumerate(model["convs"]):
        k, s, p = conv["kernel"], conv["stride"], conv["padding"]
        oy = (h + 2 * p - k) // s + 1
        ox = (w + 2 * p - k) // s + 1
        out.append(("conv", "conv%d" % (i + 1), {
            "shape": (oy, ox, conv["filters"]),
            "macs": oy * ox * conv["filters"] * k * k * c}))
        h, w, c = oy, ox, conv["filters"]
        if conv.get("lrn"):
            out.append(("lrn", "lrn%d" % (i + 1), {"shape": (h, w, c)}))
        if conv.get("pool"):
            pk, ps = model["pool"]["kernel"], model["pool"]["stride"]
            h = -(-max(h - pk, 0) // ps) + 1
            w = -(-max(w - pk, 0) // ps) + 1
            out.append(("pool", "pool%d" % (i + 1), {"shape": (h, w, c)}))
    n_in = h * w * c
    widths = list(model["fc"]) + [int(model["num_classes"])]
    for i, n_out in enumerate(widths):
        out.append(("fc", "fc%d" % (len(model["convs"]) + 1 + i), {
            "shape": (n_out,), "macs": n_in * n_out}))
        n_in = n_out
    return out


def alexnet_train_flops_per_image(model):
    """2 FLOPs a multiply-accumulate of every conv and FC, ×3 for the
    forward and the two backward products."""
    macs = sum(d["macs"] for kind, _, d in alexnet_layers(model)
               if kind in ("conv", "fc"))
    return 6.0 * macs


def alexnet_step_flops(model, traffic):
    return alexnet_train_flops_per_image(model) \
        * int(traffic["minibatch_size"])


def alexnet_bias_grad_step_bytes(model, traffic):
    """Bytes one train step's bias sums need: each conv's and hidden FC's
    bf16 error and output read once (the derivative is of the output),
    the softmax layer's bf16 error alone, and every f32 bias gradient
    written once."""
    mb = int(traffic["minibatch_size"])
    total = 0
    layers = [d for kind, _, d in alexnet_layers(model)
              if kind in ("conv", "fc")]
    for i, d in enumerate(layers):
        rows = mb
        for n in d["shape"][:-1]:
            rows *= n
        k = d["shape"][-1]
        reads = 1 if i == len(layers) - 1 else 2
        total += reads * rows * k * BF16 + k * F32
    return total

