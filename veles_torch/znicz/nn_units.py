"""NN base units of the PyTorch port and its layer registry.

Counterpart of ``veles/znicz_tpu/nn_units.py``:

* :class:`Forward` — an ``nn.Module`` owning ``weights``/``bias``
  buffers, filled from the ``"default"`` numpy generator exactly as the
  reference fills them (same draws at the same seed);
* :class:`GradientDescentBase` — the explicit backward unit: learning
  rates and their schedules (``lr_adjust.py``), L2/L1 decay, momentum or
  AdamW, gradient accumulation, ``lr_scale``; parameters beyond
  weights/bias (``EXTRA_PARAMS``: the attention out-projection, the
  FFN's second layer) get their own ``vel_``/``acc_``/``sq_<name>``
  state under the reference's key names. Every bias
  gradient goes through ``ops/bias_grad.bias_grad``: the kernel on the
  card, its plain version on the CPU. A forward's ``zero_mask`` (set by
  ``ops/cutter.ZeroFiller``) multiplies its weights inside each update,
  once per step, as the reference's traced update does;
* the wire of the master/slave mode (``distributable.py``): every
  parameter the forward declares in ``PARAMS`` rides the wire as a host
  ``numpy.float32`` array under the reference's payload keys. The master
  ships its canonical weights (through the slave's negotiated codec,
  ``compression.py``); a slave writes them in place into its device
  tensors, remembers the decoded basis, trains, and ships ``d<name>``
  deltas against it; the master adds each delta times
  ``slave_merge_scale`` (an absolute payload is averaged halfway) and
  reports the non-finite entries it merged to the model-health monitor.
  Momentum and Adam moments stay on the slave;
* on a mesh (``veles_torch/znicz/parallel``) the step sets ``deferred``
  to a list: :meth:`GradientDescentBase.update_weights` and
  :meth:`GradientDescentBase.update_extra` then only record their
  gradients, each with the mesh axes it is summed over
  (``reduce_axes``: a parameter's own, or None for the step's), and
  :func:`flush_deferred` runs the recorded updates, in order, on the
  gradients summed over the ranks;
* the registry mapping config names to forward classes and forward
  classes to their GD classes. It is the port's own, separate from the
  reference's, so a process can hold both packages.

The backward is the reference's hand-written GD math, not autograd.
"""

import numpy
import torch
from torch import nn

from veles_torch import compression, model_health, prng
from veles_torch.distributable import IDistributable
from veles_torch.znicz.lr_adjust import make_policy

_FORWARD_BY_NAME = {}
_GRADIENT_FOR = {}


def forward_unit(name):
    """Class decorator: register a Forward unit under a config name."""
    def deco(cls):
        cls.MAPPING = name
        _FORWARD_BY_NAME[name] = cls
        return cls
    return deco


def gradient_for(forward_cls):
    """Class decorator: register a GD unit as the backward pair of a
    Forward class."""
    def deco(cls):
        cls.FORWARD = forward_cls
        _GRADIENT_FOR[forward_cls] = cls
        return cls
    return deco


def forward_by_name(name):
    try:
        return _FORWARD_BY_NAME[name]
    except KeyError:
        raise KeyError("unknown layer type %r (known: %s)"
                       % (name, ", ".join(sorted(_FORWARD_BY_NAME))))


def gradient_unit_for(forward_cls):
    for cls in forward_cls.__mro__:
        if cls in _GRADIENT_FOR:
            return _GRADIENT_FOR[cls]
    raise KeyError("no gradient unit registered for %s"
                   % forward_cls.__name__)


class Forward(nn.Module):
    """Base forward unit: input -> output with weights/bias buffers."""

    MAPPING = None
    PARAMS = ("weights", "bias")

    def __init__(self, name=None, include_bias=True,
                 weights_transposed=False, weights_filling="uniform",
                 weights_stddev=None, bias_filling="constant",
                 bias_stddev=0.0, prng_key="default"):
        super().__init__()
        self.name = name or type(self).__name__
        self.include_bias = include_bias
        self.weights_transposed = weights_transposed
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        self.prng = prng.get(prng_key)
        #: the TorchDevice this unit computes on (set by initialize)
        self.device = None
        #: the (B, ...) shape of this unit's input, set by the workflow
        #: before initialize (what ``output_shape_source`` reads)
        self.input_shape = None
        #: weights mask of a ZeroFiller: masked entries stay 0
        self.zero_mask = None
        for param in dict.fromkeys(("weights", "bias") + self.PARAMS):
            self.register_buffer(param, None)

    def fill_array(self, arr, filling, stddev):
        if filling == "uniform":
            bound = stddev * numpy.sqrt(3.0)
            self.prng.fill_uniform(arr, -bound, bound)
        elif filling == "gaussian":
            self.prng.fill_normal(arr, 0.0, stddev)
        elif filling == "constant":
            arr[...] = stddev
        else:
            raise ValueError("unknown filling %r" % filling)

    def default_weights_stddev(self, fan_in, fan_out):
        # Glorot scale
        return float(numpy.sqrt(2.0 / (fan_in + fan_out)))

    def init_weights(self, w_shape, fan_in, fan_out):
        """Fill weights (and a non-constant bias) on the host from the
        numpy generator, then place them on the device."""
        stddev = self.weights_stddev or \
            self.default_weights_stddev(fan_in, fan_out)
        w = numpy.zeros(w_shape, numpy.float32)
        self.fill_array(w, self.weights_filling, stddev)
        self.weights = torch.as_tensor(w).to(self.device.device)
        if self.include_bias:
            b = numpy.zeros(fan_out, numpy.float32)
            if self.bias_filling != "constant" or self.bias_stddev:
                self.fill_array(b, self.bias_filling,
                                self.bias_stddev or 0.01)
            self.bias = torch.as_tensor(b).to(self.device.device)

    def export_params(self):
        return {n: getattr(self, n) for n in self.PARAMS
                if getattr(self, n) is not None}


class GradientDescentBase(IDistributable):
    """Base backward unit: err_output -> err_input + parameter update.

    Update rules (the reference's traced ones,
    ``veles/znicz_tpu/nn_units.py``):

    * ``solver="momentum"``: ``reg = grad + l2·(1−l1_vs_l2)·W +
      l2·l1_vs_l2·sign(W)``; ``vel = moment·vel − lr·reg``; ``W += vel``;
    * ``solver="adam"`` (AdamW): beta1 is ``gradient_moment``, the second
      moment ``sq_*`` decays by ``adam_beta2``, the decay ``l2·W`` is
      decoupled (added to the step, not the gradient), and the bias
      correction counts applied steps as the f32 ``(t+1)/accumulate``;

    with separate lr / decay / moment for the bias. ``lr`` is the base rate
    through the unit's lr policy (``lr_adjust.py``, evaluated on the
    device's ``iteration`` counter), THEN times ``lr_scale``: a policy that
    replaces the base rate (``arbitrary_step``) keeps the scale. With
    ``accumulate_gradient = N > 1`` the gradients add up in ``acc_*`` (the
    grown sum is stored) and every N-th step applies it and zeroes it;
    weights, ``vel_*`` and ``sq_*`` move only on that step.
    """

    FORWARD = None
    ACTIVATION = "linear"
    STATE = ("vel_weights", "vel_bias", "acc_weights", "acc_bias",
             "sq_weights", "sq_bias", "acc_count", "iteration")
    #: (param_name, bias_like) of forward parameters beyond
    #: weights/bias; ``vel_<p>``, ``acc_<p>`` and ``sq_<p>`` join STATE.
    #: ``bias_like`` picks the bias hyper-parameters (lr_bias,
    #: moment_bias, decay_bias, lr_policy_bias)
    EXTRA_PARAMS = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        derived = [n for p, _ in cls.__dict__.get("EXTRA_PARAMS", ())
                   for n in ("vel_" + p, "acc_" + p, "sq_" + p)]
        if derived:
            cls.STATE = tuple(cls.STATE) + tuple(
                n for n in derived if n not in cls.STATE)

    def __init__(self, name=None, need_err_input=True, learning_rate=0.01,
                 learning_rate_bias=None, weights_decay=0.0,
                 weights_decay_bias=0.0, l1_vs_l2=0.0, l1_vs_l2_bias=None,
                 gradient_moment=0.0, gradient_moment_bias=None,
                 solver="momentum", adam_beta2=0.999, adam_eps=1e-8,
                 accumulate_gradient=1, lr_policy=None, lr_policy_bias=None,
                 fused_bias_grad=None):
        self.name = name or type(self).__name__
        self.need_err_input = need_err_input
        self.learning_rate = learning_rate
        self.learning_rate_bias = learning_rate if learning_rate_bias is None \
            else learning_rate_bias
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.l1_vs_l2_bias = l1_vs_l2 if l1_vs_l2_bias is None \
            else l1_vs_l2_bias
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = gradient_moment \
            if gradient_moment_bias is None else gradient_moment_bias
        if solver not in ("momentum", "adam"):
            raise ValueError("solver must be 'momentum' or 'adam', got %r"
                             % (solver,))
        self.solver = solver
        self.adam_beta2 = float(adam_beta2)
        self.adam_eps = float(adam_eps)
        self.accumulate_gradient = int(accumulate_gradient)
        self.lr_policy = make_policy(lr_policy)
        self.lr_policy_bias = make_policy(
            lr_policy if lr_policy_bias is None else lr_policy_bias)
        # accepted so layer configs shared with the reference load; the
        # port always takes the bias gradient through ops/bias_grad
        self.fused_bias_grad = fused_bias_grad
        #: multiplier on both learning rates, applied after the policy
        self.lr_scale = 1.0
        #: this step's (lr, adam corrections) by weight/bias set
        self._scalars = {}
        #: a list while the step's layer stats are due: ``update_weights``
        #: appends ``(name, tensors)`` for :func:`layer_stats`
        self.stats_sink = None
        self.forward = None
        #: the workflow (its negotiated wire codecs), set by it
        self.workflow = None
        #: master side: the factor on each merged slave delta
        self.slave_merge_scale = 1.0
        #: slave side: the decoded weights of the last master payload,
        #: and the host copy of the trained parameters the step left
        #: after the job (``TorchStep.run_job``)
        self._master_basis = None
        self.wire_host = None
        #: a list while a mesh step defers the updates (flush_deferred)
        self.deferred = None
        #: {parameter: mesh axes its gradient is summed over} where they
        #: are not the step's (an expert shard's, set by the parallel
        #: setups)
        self.reduce_axes = {}
        for key in dict.fromkeys(GradientDescentBase.STATE + self.STATE):
            setattr(self, key, None)

    def setup_forward(self, forward):
        """Bind to the paired forward unit."""
        self.forward = forward
        return self

    @property
    def adam(self):
        return self.solver == "adam"

    @property
    def accumulating(self):
        return self.accumulate_gradient > 1

    def initialize(self):
        f = self.forward
        if f is None:
            raise ValueError("%s: setup_forward() not called" % self.name)
        params = [("weights", f.weights)]
        if f.include_bias:
            params.append(("bias", f.bias))
        params += [(p, getattr(f, p)) for p, _ in self.EXTRA_PARAMS]
        for pname, src in params:
            if src is None:
                continue
            setattr(self, "vel_" + pname, torch.zeros_like(src))
            if self.accumulating:
                setattr(self, "acc_" + pname, torch.zeros_like(src))
            if self.adam:
                setattr(self, "sq_" + pname, torch.zeros_like(src))
        device = f.weights.device
        self.iteration = torch.zeros((), dtype=torch.int32, device=device)
        if self.accumulating:
            self.acc_count = torch.zeros((), dtype=torch.int32,
                                         device=device)

    def export_state(self):
        return {n: getattr(self, n) for n in self.STATE
                if getattr(self, n) is not None}

    def hyperparams(self):
        """The update's scalars, rounded to float32 as the reference's
        traced hyper-parameters are."""
        f32 = numpy.float32
        return {
            "lr": f32(self.learning_rate),
            "lr_bias": f32(self.learning_rate_bias),
            "l2": f32(self.weights_decay),
            "l2_bias": f32(self.weights_decay_bias),
            "l1_vs_l2": f32(self.l1_vs_l2),
            "l1_vs_l2_bias": f32(self.l1_vs_l2_bias),
            "moment": f32(self.gradient_moment),
            "moment_bias": f32(self.gradient_moment_bias),
            "lr_scale": f32(self.lr_scale),
            "beta2": f32(self.adam_beta2),
            "adam_eps": f32(self.adam_eps),
        }

    def step_scalars(self, h, bias_like, t):
        """(lr, adam's bias corrections ``1 − beta1**step`` and ``1 −
        beta2**step`` or None) of this step for the weight-like or the
        bias-like parameters, computed once a step and shared by every
        parameter of the set (the same values the reference computes for
        each). ``lr`` is the base rate through the policy, on the device
        at iteration ``t``, then times ``lr_scale``; without a policy, the
        f32 product as a Python float."""
        key = bool(bias_like)
        if key not in self._scalars:
            sfx = "_bias" if bias_like else ""
            policy = self.lr_policy_bias if bias_like else self.lr_policy
            if policy is None:
                lr = float(h["lr" + sfx] * h["lr_scale"])
            else:
                lr = policy(float(h["lr" + sfx]), t) * float(h["lr_scale"])
            corrections = None
            if self.adam:
                step = (t + 1).to(torch.float32) / max(
                    1, self.accumulate_gradient)
                beta1 = h["moment_bias" if bias_like else "moment"]
                corrections = (1.0 - torch.pow(float(beta1), step),
                               1.0 - torch.pow(float(h["beta2"]), step))
            self._scalars[key] = (lr, corrections)
        return self._scalars[key]

    @staticmethod
    def apply_update(w, vel, grad, lr, moment, l2, l1_vs_l2):
        """-> (new w, new vel); scalars are float32 numpy values, ``lr`` a
        Python float or an f32 device scalar."""
        f32 = numpy.float32
        reg = grad + w * float(l2 * (f32(1.0) - l1_vs_l2)) \
            + torch.sign(w) * float(l2 * l1_vs_l2)
        vel = vel * float(moment) - lr * reg
        return w + vel, vel

    @staticmethod
    def apply_update_adam(w, m, v, grad, lr, beta1, beta2, eps, l2,
                          corrections):
        """AdamW -> (new w, new m, new v): bias-corrected moments and the
        decoupled decay ``l2·w``; ``corrections`` are ``1 − beta**step``
        of both moments, ``step`` counting applied updates from 1."""
        f32 = numpy.float32
        m = float(beta1) * m + float(f32(1.0) - beta1) * grad
        v = float(beta2) * v + float(f32(1.0) - beta2) * grad * grad
        mhat = m / corrections[0]
        vhat = v / corrections[1]
        w = w - lr * (mhat / (torch.sqrt(vhat) + float(eps))
                      + float(l2) * w)
        return w, m, v

    def _step_param(self, pname, grad, apply_now, t, h, bias_like):
        """One (possibly accumulated) step of the forward's parameter
        ``pname`` under the configured solver, its state updated in
        place of the old tensors."""
        f = self.forward
        sfx = "_bias" if bias_like else ""
        w = getattr(f, pname)
        vel = getattr(self, "vel_" + pname)
        acc = getattr(self, "acc_" + pname) if self.accumulating else None
        lr, corrections = self.step_scalars(h, bias_like, t)
        g = grad.to(w.dtype)
        if acc is not None:
            g = acc + g
        sq = nsq = None
        if self.adam:
            sq = getattr(self, "sq_" + pname)
            nw, nv, nsq = self.apply_update_adam(
                w, vel, sq, g, lr, h["moment" + sfx], h["beta2"],
                h["adam_eps"], h["l2" + sfx], corrections)
        else:
            nw, nv = self.apply_update(w, vel, g, lr, h["moment" + sfx],
                                       h["l2" + sfx], h["l1_vs_l2" + sfx])
        if acc is not None:
            nw = torch.where(apply_now, nw, w)
            nv = torch.where(apply_now, nv, vel)
            # the GROWN accumulator, zeroed once applied
            setattr(self, "acc_" + pname,
                    torch.where(apply_now, torch.zeros_like(g), g))
            if nsq is not None:
                nsq = torch.where(apply_now, nsq, sq)
        setattr(f, pname, nw)
        setattr(self, "vel_" + pname, nv)
        if nsq is not None:
            setattr(self, "sq_" + pname, nsq)

    def update_weights(self, grad_w, grad_b):
        """One step of the paired forward's weights and bias; advances
        ``iteration`` (and the accumulation count). While ``deferred`` is
        a list, the step is recorded there instead."""
        if self.deferred is not None:
            self.deferred.append((
                self._update_weights, [grad_w, grad_b],
                [self.reduce_axes.get(p) for p in ("weights", "bias")]))
            return
        self._update_weights(grad_w, grad_b)

    def _update_weights(self, grad_w, grad_b):
        f = self.forward
        h = self.hyperparams()
        t = self.iteration
        self._scalars = {}
        apply_now = None
        if self.accumulating:
            count = self.acc_count + 1
            apply_now = count >= self.accumulate_gradient
            self.acc_count = torch.where(apply_now, 0, count).to(
                torch.int32)
        # the updates rebind new tensors: the old ones stay intact for
        # the stats
        old_w, old_b = f.weights, f.bias
        self._step_param("weights", grad_w, apply_now, t, h, False)
        if f.zero_mask is not None:
            f.weights = f.weights * f.zero_mask
        with_bias = f.include_bias and grad_b is not None
        if with_bias:
            self._step_param("bias", grad_b, apply_now, t, h, True)
        self.iteration = t + 1
        if self.stats_sink is not None:
            pairs = [(grad_w, old_w, f.weights)]
            if with_bias:
                pairs.append((grad_b, old_b, f.bias))
            self.stats_sink.append((self.name, pairs))

    def update_extra(self, grads):
        """One step of each EXTRA_PARAMS parameter with a gradient in
        ``grads`` ({name: grad or None}), under the weight or bias
        hyper-parameters, in lockstep with :meth:`update_weights` (which
        must run first: ``t = iteration − 1``, applied when ``acc_count``
        is back at 0; the step's scalars are those it computed). While
        ``deferred`` is a list, the step is recorded there instead."""
        if self.deferred is not None:
            names = [p for p, _ in self.EXTRA_PARAMS]
            self.deferred.append((
                lambda *g: self._update_extra(dict(zip(names, g))),
                [grads.get(p) for p in names],
                [self.reduce_axes.get(p) for p in names]))
            return
        self._update_extra(grads)

    def _update_extra(self, grads):
        h = self.hyperparams()
        t = self.iteration - 1
        apply_now = self.acc_count == 0 if self.accumulating else None
        for pname, bias_like in self.EXTRA_PARAMS:
            grad = grads.get(pname)
            if grad is not None:
                self._step_param(pname, grad, apply_now, t, h, bias_like)


    # -- IDistributable: parameters over the wire ------------------------

    def _wire_params(self):
        """(name, tensor) of EVERY parameter the forward declares in
        ``PARAMS`` (attention and FFN units have more than
        weights/bias)."""
        f = self.forward
        out = []
        for name in getattr(f, "PARAMS", ("weights", "bias")):
            t = getattr(f, name, None)
            if t is not None and t.numel():
                out.append((name, t))
        return out

    def _param_values(self):
        """{name: float32 ndarray} of every wire parameter: the host copy
        the step left after a job when there is one (taken once), else a
        copy of the tensors."""
        host, self.wire_host = self.wire_host, None
        if host is not None:
            return host
        return {name: t.detach().to("cpu", torch.float32).numpy().copy()
                for name, t in self._wire_params()}

    def _codec_for(self, slave=None):
        """The wire codec of one payload: on the master the encoder
        minted for ``slave`` at its hello (``grad_codec_by_slave``), on a
        slave the negotiated one (``grad_codec``); None passes through."""
        wf = self.workflow
        if slave is not None:
            table = getattr(wf, "grad_codec_by_slave", None)
            if table is not None:
                return table.get(slave)
        return getattr(wf, "grad_codec", None)

    def generate_data_for_slave(self, slave=None):
        values = self._param_values()
        codec = self._codec_for(slave)
        if codec is None:
            return values
        # dense broadcast, stateless: the canonical fp32 weights live
        # here, so broadcast error never accumulates
        return {name: codec.encode_broadcast(
            "%s/%s" % (self.name, name), value)
            for name, value in values.items()}

    def apply_data_from_master(self, data):
        """Write the master's weights in place into the device tensors
        (the step holds them) and keep the decoded basis the deltas are
        taken against."""
        if not data:
            return
        decoded = {k: numpy.asarray(compression.decode(v), numpy.float32)
                   for k, v in data.items()}
        for name, t in self._wire_params():
            if name not in decoded:
                # a declared parameter left out would drift apart
                # across slaves without a word
                raise KeyError("%s: master payload missing %r (version "
                               "skew?)" % (self.name, name))
            value = decoded[name]
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError("%s: master payload %r has shape %s, the "
                                 "unit's is %s" % (self.name, name,
                                                   value.shape,
                                                   tuple(t.shape)))
            with torch.no_grad():
                t.copy_(torch.from_numpy(value))
        self._master_basis = {k: numpy.array(v) for k, v in decoded.items()}
        self.wire_host = None

    def generate_data_for_master(self):
        current = self._param_values()
        basis = self._master_basis
        if basis is None:
            return current
        deltas = {k: current[k] - basis[k] for k in current}
        codec = self._codec_for(None)
        if codec is None:
            return {"d" + k: v for k, v in deltas.items()}
        # lossy is fine for deltas: the codec's error-feedback residual
        # folds this sync's quantization error into the next delta
        return {"d" + k: codec.encode_update("%s/%s" % (self.name, k), v)
                for k, v in deltas.items()}

    def apply_data_from_slave(self, data, slave=None):
        """Merge one slave's training into the canonical weights, in
        numpy on the host as the reference merges: ``d<name>`` deltas
        add times ``slave_merge_scale``; an absolute payload is averaged
        halfway. The non-finite entries merged go to the model-health
        monitor (0 for a clean merge)."""
        if not data:
            return
        scale = float(self.slave_merge_scale)
        nonfinite = 0
        for key, t in self._wire_params():
            if "d" + key in data:
                delta = compression.decode(data["d" + key])
                nonfinite += int((~numpy.isfinite(delta)).sum())
                value = t.detach().cpu().numpy()
                value[...] += scale * delta
            elif key in data:
                other = compression.decode(data[key])
                nonfinite += int((~numpy.isfinite(other)).sum())
                value = t.detach().cpu().numpy()
                value[...] = 0.5 * (value + other)
            else:
                continue
            if t.device.type != "cpu":
                with torch.no_grad():
                    t.copy_(torch.from_numpy(value))
        model_health.get_model_monitor().note_wire_nonfinite(
            self.name, nonfinite, slave=slave)

def flush_deferred(entries, reduce):
    """Run the updates the GD units recorded in ``deferred`` (``[(update,
    [grad or None, ...], [axes or None, ...]), ...]``), in order, after
    ``reduce`` (a flat f32 tensor and its axes -> the same summed over the
    ranks) ran ONCE per distinct axes over every gradient of them, packed
    one after another (in the order the axes first appear, the same on
    every rank)."""
    groups = {}
    for e, (_, grads, axes) in enumerate(entries):
        for i, g in enumerate(grads):
            if g is not None:
                groups.setdefault(axes[i], []).append((e, i, g))
    summed = {}
    for axes, items in groups.items():
        flat = reduce(torch.cat([g.reshape(-1).to(torch.float32)
                                 for _, _, g in items]), axes)
        pos = 0
        for e, i, g in items:
            summed[e, i] = flat[pos:pos + g.numel()].view(g.shape)
            pos += g.numel()
    for e, (update, grads, _) in enumerate(entries):
        update(*[None if g is None else summed[e, i]
                 for i, g in enumerate(grads)])


#: (device, owners) -> the device index tensor of layer_stats
_STATS_INDEX = {}


def layer_stats(entries, reduce=None):
    """The model-health stat vectors of one train step: ``entries`` is
    ``[(name, [(grad, old, new), ...]), ...]`` (a GD unit's weights, then
    its bias when the step updated one; the extra parameters are left
    out, as in the reference); -> an ``(len(entries), 4)`` f32 tensor of
    ``STAT_FIELDS`` rows: ``[‖grad‖, ‖new‖, ‖new − old‖ / (‖new‖ +
    1e-12), non-finite entries of the gradients]``, each norm over the
    unit's weights and bias together, in f32. The reductions of all
    units run grouped (``torch._foreach_*``); the non-finite count is the
    count of non-zeros of ``grad − grad``, 0 where an entry is finite and
    NaN where it is not. ``reduce`` (TP: the sharded units' sums over the
    model axis) maps the (4, units) squared norms and counts before the
    square roots."""
    f32 = torch.float32

    def as_f32(t):
        return t if t.dtype == f32 else t.to(f32)

    grads, news, olds, owner = [], [], [], []
    for u, (_, pairs) in enumerate(entries):
        for grad, old, new in pairs:
            grads.append(as_f32(grad))
            olds.append(as_f32(old))
            news.append(as_f32(new))
            owner.append(u)
    dev = grads[0].device
    # made once: a copy from pageable host memory can wait for the device
    key = (str(dev), tuple(owner))
    if key not in _STATS_INDEX:
        _STATS_INDEX[key] = torch.tensor(owner, device=dev)
    deltas = torch._foreach_sub(news, olds)
    norms = torch.stack(
        torch._foreach_norm(grads) + torch._foreach_norm(news)
        + torch._foreach_norm(deltas)
        + torch._foreach_norm(torch._foreach_sub(grads, grads), 0)
    ).view(4, -1)
    rows = torch.cat([norms[:3] * norms[:3], norms[3:]])
    per = torch.zeros((4, len(entries)), dtype=f32, device=dev).index_add_(
        1, _STATS_INDEX[key], rows)
    if reduce is not None:
        per = reduce(per)
    gnorm, wnorm, unorm = torch.sqrt(per[:3])
    return torch.stack([gnorm, wnorm, unorm / (wnorm + 1e-12), per[3]], 1)


class RoutingGradientBase(GradientDescentBase):
    """Backward unit of a forward without parameters (pooling, LRN,
    dropout): it only transforms the error, so it has no state and no
    update."""

    STATE = ()

    def initialize(self):
        if self.forward is None:
            raise ValueError("%s: setup_forward() not called" % self.name)
