"""Archive loading and the forward interpreter of the port's serving
planes.

Counterpart of ``veles/serving/model.py``. ``export_inference`` (either
package's) writes ``contents.json`` + ``*.npy``; :class:`ArchiveModel`
loads that archive onto a device and evaluates it as a pure function
``apply(params, x)`` on torch tensors, in float32. The per-type forward
math is the port's own training math wherever the training units have
it as a function (``dense_attention_core_fwd``, ``ln_fwd``,
``conv_geometry``, ``max_pool``/``avg_pool``, ``deconv_fwd``/``depool``,
``lrn_denominator``/``lrn_dpow``, the activation table), so serving
cannot drift from training (the stacked block's ``block_fwd``, the MoE
FFN's ``moe_forward``, routed per sample). Unknown unit types fail
loudly, as the C++ ``UnitFactory`` does.

The convolutions (and the deconvolution's transposed ones) run in true
f32: cuDNN's TF32 is switched off for each serving convolution call (and
restored after), whatever the process's default, as the reference serves
in f32.

Parameters live outside the specs (a ``{unit_name: {key: tensor}}``
tree), so an engine can hold its own device copy and swap new weights
in without touching the specs.
"""

import contextlib
import json
import os

import numpy
import torch
import torch.nn.functional as F

from veles_torch.backends import torch_device
from veles_torch.serving.quant import dense_params, tree_to
from veles_torch.snapshotter import COUNTERS, is_diverged, load_snapshot_meta
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.ops import conv_math as CM
from veles_torch.znicz.ops.attention import dense_attention_core_fwd
from veles_torch.znicz.ops.conv import conv_geometry
from veles_torch.znicz.ops.deconv import deconv_fwd, depool
from veles_torch.znicz.ops.flash_attention import MASK_VALUE, scale_for
from veles_torch.znicz.ops.layernorm import ln_fwd
from veles_torch.znicz.ops.moe import moe_forward
from veles_torch.znicz.ops.normalization import lrn_denominator, lrn_dpow
from veles_torch.znicz.ops.pooling import avg_pool, max_pool
from veles_torch.znicz.parallel.pipeline import ACT, block_fwd


def _act(name, v):
    return A.ACTIVATIONS[name][0](v)


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN's TF32 off inside the block, restored after."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


def split_heads(t, heads):
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


def merge_heads(t):
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


# -- per-type forward functions: fn(x, p, spec) -> y ------------------------


def _dense(act):
    def fn(x, p, spec):
        cfg = spec["config"]
        x2 = x.reshape(x.shape[0], -1)
        w = p["weights"]
        v = torch.matmul(x2, w.t() if spec.get("weights_transposed")
                         else w)
        if p.get("bias") is not None:
            v = v + p["bias"]
        sample = tuple(cfg.get("output_sample_shape")
                       or (cfg["neurons"],))
        return _act(act, v).reshape((x.shape[0],) + sample)
    return fn


def _conv(act):
    def fn(x, p, spec):
        cfg = spec["config"]
        xc, w, pad = conv_geometry(
            x, p["weights"], cfg["ky"], cfg["kx"],
            CM.normalize_padding(tuple(cfg["padding"])))
        with f32_convolutions():
            v = F.conv2d(xc, w, stride=tuple(cfg["sliding"]),
                         padding=pad).permute(0, 2, 3, 1)
        if p.get("bias") is not None:
            v = v + p["bias"]
        return _act(act, v).contiguous()
    return fn


def _max_pool(x, p, spec):
    cfg = spec["config"]
    return max_pool(x, cfg["ky"], cfg["kx"], tuple(cfg["sliding"]))[0]


def _avg_pool(x, p, spec):
    cfg = spec["config"]
    return avg_pool(x, cfg["ky"], cfg["kx"], tuple(cfg["sliding"]))


def _f32_conv_transpose(x, w, stride):
    with f32_convolutions():
        return F.conv_transpose2d(x, w, stride=stride)


def _deconv(x, p, spec):
    cfg = spec["config"]
    return deconv_fwd(x, p["weights"], cfg["ky"], cfg["kx"],
                      cfg["sliding"], CM.normalize_padding(
                          tuple(cfg["padding"])),
                      cfg["out_shape"][:2], _f32_conv_transpose).contiguous()


def _depooling(x, p, spec):
    cfg = spec["config"]
    return depool(x, cfg["ky"], cfg["kx"], tuple(cfg["sliding"]),
                  cfg["out_shape"][:2]).contiguous()


def _lrn(x, p, spec):
    cfg = spec["config"]
    return x * lrn_dpow(lrn_denominator(x, cfg["alpha"], cfg["n"],
                                        cfg["k"]), cfg["beta"])


def _embedding(x, p, spec):
    ids = x.long()
    y = p["weights"][ids]
    pos = p.get("positions")
    if pos is not None:
        s = ids.shape[1]
        if s > pos.shape[0]:
            raise ValueError(
                "%s: sequence %d longer than the exported positions "
                "table (%d)" % (spec["name"], s, pos.shape[0]))
        y = y + pos[:s]
    return y


def _layernorm(x, p, spec):
    return ln_fwd(x, p["weights"], p["bias"], spec["config"]["eps"])


def _token_dense(act):
    def fn(x, p, spec):
        v = torch.matmul(x, p["weights"])
        if p.get("bias") is not None:
            v = v + p["bias"]
        return _act(act, v)
    return fn


def _ffn(x, p, spec):
    h = _act("strict_relu", torch.matmul(x, p["weights"]) + p["bias"])
    y = torch.matmul(h, p["weights2"]) + p["bias2"]
    return y + x if spec["config"]["residual"] else y


def attention_kv(x, p, cfg):
    """Self-attention over (B, S, D) -> (y, k, v), k and v the (B, H, S,
    dh) heads a decoder caches."""
    heads = cfg["heads"]
    d = x.shape[-1]
    qkv = torch.matmul(x, p["weights"])
    if p.get("bias") is not None:
        qkv = qkv + p["bias"]
    q = split_heads(qkv[..., :d], heads)
    k = split_heads(qkv[..., d:2 * d], heads)
    v = split_heads(qkv[..., 2 * d:], heads)
    _, ctx = dense_attention_core_fwd(q, k, v, cfg["causal"],
                                      scale_for(d // heads))
    y = torch.matmul(merge_heads(ctx), p["weights_out"])
    if p.get("bias_out") is not None:
        y = y + p["bias_out"]
    return (y + x if cfg["residual"] else y), k, v


def attn_decode(x, pos, kv, p, heads, include_bias, residual):
    """One decode step through an attention layer: ``x`` (B, 1, D),
    ``kv`` = (K, V) caches (B, H, maxlen, dh) written IN PLACE at each
    row's own position ``pos`` (a (B,) long tensor), which each row's
    query attends up to; -> y (B, 1, D)."""
    b, _, d = x.shape
    dh = d // heads
    K, V = kv
    qkv = torch.matmul(x, p["weights"])
    if include_bias:
        qkv = qkv + p["bias"]
    q = split_heads(qkv[..., :d], heads)
    rows = torch.arange(b, device=x.device)
    K[rows, :, pos] = split_heads(qkv[..., d:2 * d], heads)[:, :, 0]
    V[rows, :, pos] = split_heads(qkv[..., 2 * d:], heads)[:, :, 0]
    scores = torch.matmul(q, K.transpose(-1, -2))[:, :, 0, :] \
        * scale_for(dh)
    mask = torch.arange(K.shape[2], device=x.device)[None, :] \
        > pos[:, None]
    scores = torch.where(mask[:, None, :], MASK_VALUE, scores)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    ctx = torch.matmul(probs[:, :, None, :], V)            # (B, H, 1, dh)
    y = torch.matmul(merge_heads(ctx), p["weights_out"])
    if include_bias:
        y = y + p["bias_out"]
    return y + x if residual else y


def block_decode(x, pos, kv, lp, heads, eps):
    """One decode step through a stacked transformer block: the attention
    on its cache (:func:`attn_decode`, K/V written in place), then the
    block's layernorms and FFN; -> y (B, 1, D)."""
    a = attn_decode(x, pos, kv, {k: lp[k] for k in (
        "weights", "bias", "weights_out", "bias_out")}, heads, True, True)
    n1 = ln_fwd(a, lp["ln1_g"], lp["ln1_b"], eps)
    h = _act(ACT, torch.matmul(n1, lp["ffn_w1"]) + lp["ffn_b1"])
    fo = torch.matmul(h, lp["ffn_w2"]) + lp["ffn_b2"] + n1
    return ln_fwd(fo, lp["ln2_g"], lp["ln2_b"], eps)


def _attention(x, p, spec):
    return attention_kv(x, p, spec["config"])[0]


def stack_kv(x, p, cfg):
    """The stacked blocks over (B, S, D) -> (y, [(k, v) per layer])."""
    kv = []
    for i in range(cfg["layers"]):
        x, cache = block_fwd(x, {k: t[i] for k, t in p.items()},
                             cfg["heads"], cfg["causal"], cfg["eps"])
        kv.append((cache["k"], cache["v"]))
    return x, kv


def _transformer_stack(x, p, spec):
    return stack_kv(x, p, spec["config"])[0]


def _moe_ffn(x, p, spec):
    # each sample routed over its own tokens: a served answer depends on
    # its input alone, never on co-batched requests or pad rows
    cfg = spec["config"]
    y = torch.cat([moe_forward(x[i:i + 1], p, cfg["experts"],
                               cfg["capacity_factor"], "strict_relu",
                               torch.matmul)[0]
                   for i in range(x.shape[0])], dim=0)
    return y + x if cfg["residual"] else y


def _identity(x, p, spec):
    return x


def _activation(act):
    def fn(x, p, spec):
        return _act(act, x)
    return fn


#: type name -> forward fn(x, params, spec); the keys are the engine
#: types of ``export_inference.ENGINE_TYPES``
FORWARD_OPS = {
    "all2all": _dense("linear"),
    "all2all_tanh": _dense("tanh"),
    "all2all_relu": _dense("relu"),
    "all2all_str": _dense("strict_relu"),
    "all2all_sigmoid": _dense("sigmoid"),
    "softmax": _dense("softmax"),
    "conv": _conv("linear"),
    "conv_tanh": _conv("tanh"),
    "conv_relu": _conv("relu"),
    "conv_str": _conv("strict_relu"),
    "conv_sigmoid": _conv("sigmoid"),
    "max_pooling": _max_pool,
    "avg_pooling": _avg_pool,
    "deconv": _deconv,
    "depooling": _depooling,
    "norm": _lrn,
    "dropout": _identity,       # inverted dropout: inference identity
    "activation_tanh": _activation("tanh"),
    "activation_relu": _activation("relu"),
    "activation_str": _activation("strict_relu"),
    "activation_sigmoid": _activation("sigmoid"),
    "embedding": _embedding,
    "layernorm": _layernorm,
    "token_dense": _token_dense("linear"),
    "token_dense_relu": _token_dense("strict_relu"),
    "transformer_ffn": _ffn,
    "attention": _attention,
    "moe_ffn": _moe_ffn,
    "transformer_stack": _transformer_stack,
}

#: spec keys that are metadata, not .npy parameter references
_NON_PARAM_KEYS = frozenset({"type", "name", "config",
                             "weights_transposed"})


def check_unit_types(units):
    """Refuse an archive with a unit type the engines do not know
    (``ValueError``)."""
    for spec in units:
        t = spec["type"]
        if t not in FORWARD_OPS:
            raise ValueError("cannot serve unit %s: unknown type %r"
                             % (spec.get("name"), t))


class ArchiveModel:
    """A loaded inference archive: ordered unit specs + a params tree on
    ``device`` (``cuda`` unless ``cpu`` is asked for), evaluated by
    :meth:`apply`."""

    def __init__(self, workflow_name, input_sample_shape, units, params,
                 device="cuda"):
        check_unit_types(units)
        self.workflow_name = workflow_name
        self.input_sample_shape = (None if input_sample_shape is None
                                   else tuple(input_sample_shape))
        self.units = units
        self.device = torch_device(device)
        #: {unit_name: {key: f32 tensor or QuantizedTensor}}
        self.params = tree_to(params, self.device)
        #: the loaded checkpoint's manifest fields (wall_time,
        #: ingest_wall, verdict); empty while serving the archive's own
        #: params
        self.checkpoint_meta = {}

    @classmethod
    def from_dir(cls, path, device="cuda"):
        """Load ``contents.json`` and every .npy it references from an
        ``export_inference`` directory onto ``device``."""
        doc_path = os.path.join(path, "contents.json")
        with open(doc_path) as f:
            doc = json.load(f)
        if doc.get("format") != 1:
            raise ValueError("%s: unsupported archive format %r"
                             % (doc_path, doc.get("format")))
        units, params = [], {}
        for spec in doc["units"]:
            tree = {}
            for key, value in spec.items():
                if key in _NON_PARAM_KEYS or value is None:
                    continue
                if isinstance(value, str) and value.endswith(".npy"):
                    tree[key] = torch.from_numpy(numpy.ascontiguousarray(
                        numpy.load(os.path.join(path, value)),
                        numpy.float32))
            units.append(spec)
            if tree:
                params[spec["name"]] = tree
        return cls(doc.get("workflow"), doc.get("input_sample_shape"),
                   units, params, device=device)

    # -- evaluation ----------------------------------------------------

    def apply(self, params, x):
        """Forward through every unit of f32 ``x`` (B, *sample) on the
        params' device; quantized weights densify here, at dispatch."""
        with torch.no_grad():
            for spec in self.units:
                x = FORWARD_OPS[spec["type"]](
                    x, dense_params(params.get(spec["name"], {})), spec)
        return x

    def __call__(self, x):
        """:meth:`apply` of this model's params to ``x`` (array or
        tensor), on the model's device."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        return self.apply(self.params, x)

    # -- structure identity ----------------------------------------------

    def signature(self):
        """Hashable architecture identity: types, names, configs and
        param shapes (two models with equal signatures differ only in
        their parameter values)."""
        def freeze(v):
            return tuple(v) if isinstance(v, list) else v
        return tuple(
            (spec["type"], spec["name"],
             tuple(sorted((k, freeze(v))
                          for k, v in spec["config"].items())),
             tuple(sorted((k, tuple(t.shape)) for k, t in
                          self.params.get(spec["name"], {}).items())))
            for spec in self.units)

    def load_checkpoint(self, target):
        """Refresh the params from a checkpoint file (either package's):
        its ``params`` tree is keyed by unit name with the archive's keys;
        unit names and keys the archive lacks are ignored (a checkpoint
        also carries GD units), a shape mismatch raises, and so does a
        checkpoint that shares no parameter. A manifest stamped with the
        model-health verdict ``diverged`` is refused. The tensors land
        on the model's device (a quantized leaf becomes f32). -> the
        number of tensors loaded."""
        state, manifest = load_snapshot_meta(target)
        if is_diverged(manifest):
            COUNTERS.count_diverged_skip()
            raise ValueError("checkpoint %s refused: MANIFEST model-health "
                             "verdict is 'diverged'" % (target,))
        fresh = {}
        for uname, tree in state.get("params", {}).items():
            for key, value in tree.items():
                have = self.params.get(uname, {}).get(key)
                if have is None:
                    continue
                value = numpy.asarray(value, numpy.float32)
                if value.shape != tuple(have.shape):
                    raise ValueError(
                        "checkpoint %s: %s.%s shape %s != archive %s"
                        % (target, uname, key, value.shape,
                           tuple(have.shape)))
                fresh.setdefault(uname, {})[key] = torch.from_numpy(
                    numpy.ascontiguousarray(value)).to(self.device)
        if not fresh:
            raise ValueError(
                "checkpoint %s shares no parameters with this model (unit "
                "names: %s)" % (target, sorted(self.params)))
        for uname, tree in fresh.items():
            self.params[uname].update(tree)
        manifest = manifest or {}
        self.checkpoint_meta = {
            "wall_time": manifest.get("wall_time"),
            "ingest_wall": manifest.get("ingest_wall"),
            "verdict": (manifest.get("model_health") or {}).get("verdict")}
        return sum(len(tree) for tree in fresh.values())
