"""RBM (restricted Boltzmann machine) units of the PyTorch port: CD-1.

Counterpart of ``veles/znicz_tpu/ops/rbm.py``: contrastive divergence
assembled from units,

    v --[All2AllSigmoid W, hbias]--> h_pos --[Binarization]--> h_smp
      --[TiedAll2AllSigmoid Wᵀ, vbias]--> v_neg
      --[TiedAll2AllSigmoid W, hbias]--> h_neg
    BatchWeights: (vᵀh/n, Σv/n, Σh/n) of (v, h_pos) and (v_neg, h_neg)
    GradientRBM: W += lr·(vh⁺ − vh⁻), hbias += lr·(Σh⁺ − Σh⁻)/n,
                 vbias += lr·(Σv⁺ − Σv⁻)/n
    EvaluatorRBM: Σ‖v − v_neg‖² / n over the valid rows

with ``n`` the minibatch's valid rows. Weight tying: the tied layers read
the first layer's tensors when they run, so one update moves the one W
(and, for ``h_neg``, the one hidden bias) and a checkpoint holds each
once. The tied products go through ``TorchDevice.dot`` (the compute
dtype, f32 sums), as the reference's ``ctx.dot``; the statistics are f32
products. ``Binarization`` draws its uniforms from a ``torch.Generator``
keyed ``"rbm_binarize"`` whose state rides in checkpoints; its numbers
are not ``jax.random``'s, so whole runs match the reference only
statistically, and unit tests inject the uniforms (:meth:`Binarization.
sample`).

Under data parallelism (``parallel.setup_data_parallel`` sets each
unit's ``mesh`` and ``batch_axes``; ``valid`` is then (this rank's rows,
the minibatch's)) the statistics are the sums over the batch axes
(one all-reduce per :class:`BatchWeights`) divided by the minibatch's
valid count, the evaluator's row is this rank's share of the minibatch's
mean (the step's metric gather sums the shares), and
:class:`Binarization` draws the whole minibatch's uniforms and keeps its
rows, so every rank draws what the one device draws.
"""

import torch

from veles_torch import prng
from veles_torch.znicz.nn_units import Forward
from veles_torch.znicz.ops import activations as A
from veles_torch.znicz.parallel import collectives


def _row_mask(b, valid, device, dtype):
    return (torch.arange(b, device=device) < valid).to(dtype)


def _counts(valid, device):
    """(this rank's valid rows, the minibatch's count as a f32 divisor of
    at least 1) of ``valid``: a count, or on a mesh (mine, total)."""
    mine, total = valid if isinstance(valid, tuple) else (valid, valid)
    n = torch.clamp(torch.as_tensor(total, device=device)
                    .to(torch.float32), min=1.0)
    return mine, n


class Binarization(Forward):
    """{0, 1} samples of probabilities: ``u < p``, u uniform in [0, 1)."""

    PARAMS = ()

    def __init__(self, prng_key="rbm_binarize", **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.prng_key = prng_key
        self.generator = None
        #: the mesh and its batch axes (``parallel.setup_data_parallel``)
        self.mesh = None
        self.batch_axes = ()

    def initialize(self, input_shape, device):
        self.device = device
        self.generator = prng.torch_generator(self.prng_key, device.device)
        return tuple(input_shape)

    def get_state(self):
        """The generator's state (a checkpoint's ``units`` section)."""
        return {"generator": prng.generator_state(self.generator)}

    def set_state(self, state):
        prng.set_generator_state(self.generator, state["generator"])

    @staticmethod
    def sample(p, u):
        """``u < p`` as f32 of the same shape."""
        return (u < p).to(torch.float32)

    def uniforms(self, p):
        """The uniforms of ``p``'s rows: on a mesh this rank's rows of the
        whole minibatch's array (the generators, seeded alike, stay in
        step on every rank)."""
        nb = self.mesh.axis_size(self.batch_axes) \
            if self.mesh is not None else 1
        shape = (p.shape[0] * nb,) + tuple(p.shape[1:])
        u = torch.rand(shape, generator=self.generator, device=p.device)
        if nb > 1:
            lo = self.mesh.index(self.batch_axes) * p.shape[0]
            u = u[lo:lo + p.shape[0]]
        return u

    def forward(self, p):
        return self.sample(p, self.uniforms(p))


class TiedAll2AllSigmoid(Forward):
    """Dense sigmoid layer on the weights of ``weights_source`` (read
    transposed when ``transposed``); its bias is its own unless
    ``bias_source`` names the unit whose bias it reads, and then it owns
    no parameters. The output is f32."""

    PARAMS = ("bias",)

    def __init__(self, weights_source=None, transposed=False,
                 bias_source=None, output_sample_shape=None, **kwargs):
        super().__init__(**kwargs)
        self.weights_source = weights_source
        self.transposed = transposed
        self.bias_source = bias_source
        if bias_source is not None:
            self.PARAMS = ()
        self.neurons = int(output_sample_shape)

    def initialize(self, input_shape, device):
        self.device = device
        if self.bias_source is None:
            self.bias = torch.zeros(self.neurons, dtype=torch.float32,
                                    device=device.device)
        return (input_shape[0], self.neurons)

    def forward(self, x):
        w = self.weights_source.weights
        w = w.t() if self.transposed else w
        bias = (self.bias_source or self).bias
        v = self.device.dot(x.reshape(x.shape[0], -1), w) + bias
        return A.sigmoid(v).to(torch.float32)


class BatchWeights(Forward):
    """The sufficient statistics of a (visible, hidden) pair over the
    valid rows: (vᵀh/n, Σv/n, Σh/n), f32."""

    PARAMS = ()

    def __init__(self, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        #: the mesh and its batch axes (``parallel.setup_data_parallel``)
        self.mesh = None
        self.batch_axes = ()

    def initialize(self, input_shape, device):
        self.device = device
        return tuple(input_shape)

    def forward(self, v, h, valid):
        b = v.shape[0]
        mine, n = _counts(valid, v.device)
        mask = _row_mask(b, mine, v.device, torch.float32)[:, None]
        v = v.reshape(b, -1).to(torch.float32) * mask
        h = h.reshape(b, -1).to(torch.float32) * mask
        vh, vs, hs = v.t() @ h, v.sum(dim=0), h.sum(dim=0)
        if self.mesh is not None \
                and self.mesh.axis_size(self.batch_axes) > 1:
            flat = collectives.all_reduce(
                torch.cat([vh.reshape(-1), vs, hs]), self.mesh,
                self.batch_axes)
            vh = flat[:vh.numel()].view(vh.shape)
            vs = flat[vh.numel():vh.numel() + vs.numel()]
            hs = flat[vh.numel() + vs.numel():]
        return vh / n, vs / n, hs / n


class GradientRBM:
    """One CD-1 update of the hidden layer's weights and bias and the
    visible layer's bias from the positive and negative statistics."""

    STATE = ()

    def __init__(self, name="GradientRBM", learning_rate=0.1):
        self.name = name
        self.learning_rate = float(learning_rate)
        #: the All2AllSigmoid owning W and the hidden bias
        self.hidden_layer = None
        #: the TiedAll2AllSigmoid owning the visible bias
        self.visible_layer = None

    def export_state(self):
        return {}

    def run(self, pos, neg):
        """``pos``/``neg``: (vh, v_sum, h_sum) of BatchWeights."""
        lr = self.learning_rate
        hl, vl = self.hidden_layer, self.visible_layer
        hl.weights = hl.weights + lr * (pos[0] - neg[0])
        hl.bias = hl.bias + lr * (pos[2] - neg[2])
        vl.bias = vl.bias + lr * (pos[1] - neg[1])


class EvaluatorRBM:
    """Reconstruction error of the data against the CD reconstruction:
    the metrics row (mse, 0, 0, 0), ``mse`` the mean over the valid rows
    of each row's summed squared difference."""

    #: the loader array compared with the reconstruction: the data
    TARGET = "data"

    def __init__(self, name="evaluator"):
        self.name = name

    @staticmethod
    def compute(v, r, valid):
        """Σ over this rank's valid rows of the squared difference, over
        the minibatch's valid count (on one device: the mean)."""
        b = v.shape[0]
        mine, n = _counts(valid, v.device)
        mask = _row_mask(b, mine, v.device, torch.float32)[:, None]
        diff = (v.reshape(b, -1).to(torch.float32)
                - r.reshape(b, -1).to(torch.float32)) * mask
        return (diff * diff).sum() / n

    def run(self, v, r, valid):
        mse = self.compute(v, r, valid)
        zero = torch.zeros_like(mse)
        return torch.stack([mse, zero, zero, zero])
