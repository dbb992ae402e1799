"""Kohonen self-organizing map units of the PyTorch port.

Counterpart of ``veles/znicz_tpu/ops/kohonen.py``: the unsupervised path,
whose trainer owns its update rule (distance -> argmin BMU ->
neighbourhood-weighted pull) in place of a GD chain. The batch rule, as
the reference traces it:

    bmu_b     = argmin_i |w_i|² − 2·x_b·w_i
    h(i, b)   = exp(−grid_dist²(i, bmu_b) / (2σ_t²)), rows b ≥ valid zeroed
    Δw_i      = α_t · (Σ_b h(i,b) x_b / max(Σ_b h(i,b), 1e-12) − w_i)
                where Σ_b h(i,b) > 1e-12, else 0

with ``frac = min(t / decay_steps, 1)`` of the f32 ``time_step`` t, α_t
and σ_t linear from (alpha, radius) to (alpha_min, radius_min) in frac,
and ``weight_delta`` the RMS of the move. The distance keeps the
reference's expanded form (|x|² dropped): another rounding of it flips
near-tied winners, and one flipped winner moves a whole neighbourhood.
Everything is f32 on every device (the reference's products here are
plain f32 matmuls, not the compute-dtype ``dot``).

Under data parallelism (``parallel.setup_data_parallel`` sets the
trainer's ``mesh`` and ``batch_axes``) each rank finds the winners of its
own rows; the numerator ``Σ_b h(i,b) x_b`` and the denominator
``Σ_b h(i,b)`` are sums over the batch, all-reduced over the batch axes
in one call, so every rank computes the same new weights and the same
``weight_delta`` as the one device.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import Forward, forward_unit
from veles_torch.znicz.parallel import collectives


def grid_coords(sy, sx):
    """(sy·sx, 2) f32 (row, column) of each neuron of the grid."""
    yy, xx = numpy.mgrid[0:sy, 0:sx]
    return numpy.stack([yy.ravel(), xx.ravel()], axis=1) \
        .astype(numpy.float32)


def dist2(x2, w):
    """|w|² − 2·x·wᵀ of (B, F) rows ``x2`` and (N, F) weights: the
    squared distance less the per-row constant |x|²."""
    return (w * w).sum(dim=1)[None, :] - 2.0 * (x2 @ w.t())


@forward_unit("kohonen_forward")
class KohonenForward(Forward):
    """Classifier: the BMU's flat index of every sample; ``distances``
    keeps the (B, N) distances of the last call."""

    PARAMS = ("weights",)

    def __init__(self, shape=(8, 8), **kwargs):
        kwargs["include_bias"] = False
        super().__init__(**kwargs)
        self.grid_shape = tuple(shape)
        self.distances = None

    @property
    def neurons(self):
        return int(numpy.prod(self.grid_shape))

    def initialize(self, input_shape, device):
        self.device = device
        fan_in = int(numpy.prod(input_shape[1:]))
        self.init_weights((self.neurons, fan_in), fan_in, self.neurons)
        return (input_shape[0],)

    def forward(self, x):
        x2 = x.reshape(x.shape[0], -1).to(torch.float32)
        self.distances = dist2(x2, self.weights)
        return torch.argmin(self.distances, dim=1).to(torch.int32)


class KohonenTrainer:
    """The SOM update rule of a :class:`KohonenForward` (its weights),
    paired by :meth:`setup_forward`; ``time_step`` is its f32 state."""

    STATE = ("time_step",)

    def __init__(self, name="KohonenTrainer", alpha=0.5, alpha_min=0.01,
                 radius=None, radius_min=1.0, decay_steps=200.0):
        self.name = name
        self.forward = None
        self.alpha = float(alpha)
        self.alpha_min = float(alpha_min)
        self.radius = radius
        self.radius_min = float(radius_min)
        self.decay_steps = float(decay_steps)
        self.time_step = None
        self.coords = None
        #: the mesh and the batch axes the sums of :meth:`update` are
        #: all-reduced over (``parallel.setup_data_parallel``)
        self.mesh = None
        self.batch_axes = ()

    def setup_forward(self, forward):
        self.forward = forward
        return self

    def initialize(self):
        f = self.forward
        if self.radius is None:
            self.radius = float(max(f.grid_shape) / 2.0)
        device = f.weights.device
        self.time_step = torch.zeros((), dtype=torch.float32,
                                     device=device)
        self.coords = torch.as_tensor(grid_coords(*f.grid_shape)).to(device)

    def export_state(self):
        return {n: getattr(self, n) for n in self.STATE
                if getattr(self, n) is not None}

    def schedules(self, t):
        """(α, σ) at the f32 step ``t``."""
        frac = torch.clamp(t / self.decay_steps, max=1.0)
        alpha = self.alpha + (self.alpha_min - self.alpha) * frac
        sigma = self.radius + (self.radius_min - self.radius) * frac
        return alpha, sigma

    def update(self, x2, w, t, valid):
        """-> (new weights, weight_delta) of one step on (B, F) f32 rows
        ``x2`` of which the first ``valid`` count (on a mesh ``valid`` is
        (this rank's count, the minibatch's))."""
        if isinstance(valid, tuple):
            valid = valid[0]
        bmu = torch.argmin(dist2(x2, w), dim=1)
        alpha, sigma = self.schedules(t)
        diff = self.coords[None, :, :] - self.coords[bmu][:, None, :]
        g2 = (diff * diff).sum(dim=-1)
        h = torch.exp(-g2 / (2.0 * sigma * sigma))
        mask = torch.arange(x2.shape[0], device=x2.device) < valid
        h = h * mask[:, None].to(h.dtype)
        num = h.t() @ x2
        den = h.sum(dim=0)[:, None]
        if self.mesh is not None \
                and self.mesh.axis_size(self.batch_axes) > 1:
            both = collectives.all_reduce(torch.cat([num, den], dim=1),
                                          self.mesh, self.batch_axes)
            num, den = both[:, :-1], both[:, -1:]
        target = num / torch.clamp(den, min=1e-12)
        pull = torch.where(den > 1e-12, target - w, torch.zeros_like(w))
        new_w = w + alpha * pull
        return new_w, torch.sqrt(((new_w - w) ** 2).mean())

    def run(self, x, valid):
        """One step on the minibatch ``x`` (``valid`` true rows): moves the
        forward's weights, advances ``time_step``; -> weight_delta (a
        0-d device tensor)."""
        f = self.forward
        x2 = x.reshape(x.shape[0], -1).to(torch.float32)
        f.weights, delta = self.update(x2, f.weights, self.time_step, valid)
        self.time_step = self.time_step + 1.0
        return delta
