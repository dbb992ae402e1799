"""The port's conv-stack units (veles_torch/znicz/ops: conv, gd_conv,
pooling, gd_pooling, normalization, dropout) against the JAX package's
traced units on the CPU, built as tests/test_conv_stack.py builds them
(``StepCompiler`` + ``XLADevice(platform="cpu")``, the same seeded numpy
input and error, the reference's initial weights carried across).

For every geometry of the reference's ``FWD_CASES`` that the port has
(conv, pooling, LRN, dropout at ratio 0) plus the other conv activations
and a stride-remainder case: the forward output, ``err_input`` and the
parameters after one update at learning rate 1 (``w − grad``), each
within float32 summation-order error (``ATOL``). Max pooling's routing of
ties, stochastic pooling with the reference's uniforms injected, dropout
with the reference's mask injected, and the bias gradient at a conv
shape against the Pallas kernel in interpret mode are held too."""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.accelerated_units import FlowContext
from veles.znicz_tpu.ops import conv as JC
from veles.znicz_tpu.ops import dropout as JD
from veles.znicz_tpu.ops import normalization as JN
from veles.znicz_tpu.ops import pallas_grads as PG
from veles.znicz_tpu.ops import pooling as JP
from veles_torch import prng as tprng
from veles_torch.backends import TorchDevice
from veles_torch.znicz.nn_units import gradient_unit_for
from veles_torch.znicz.ops import bias_grad as TBG
from veles_torch.znicz.ops import conv as TC
from veles_torch.znicz.ops import conv_math as TCM
from veles_torch.znicz.ops import dropout as TD
from veles_torch.znicz.ops import normalization as TN
from veles_torch.znicz.ops import pooling as TP

from tests.test_conv_stack import build, xla_backward, xla_forward

#: forward, err_input and updated parameters against the reference, in
#: absolute terms (values of order 1): the same f32 math summed in
#: another order (observed at most 1.9e-6)
ATOL = 2e-5

#: the reference's FWD_CASES (tests/test_conv_stack.py) that the port
#: has, then every other conv activation and a stride remainder on both
#: axes ((7 - 2) % 2 and (6 - 3) % 2 rows/columns the forward never
#: reads)
CASES = [
    ("Conv", dict(n_kernels=4, kx=3, ky=3)),
    ("Conv", dict(n_kernels=4, kx=3, ky=2, sliding=(2, 2), padding=1)),
    ("ConvTanh", dict(n_kernels=3, kx=2, ky=2, sliding=(1, 2),
                      padding=(1, 0, 2, 1))),
    ("ConvRELU", dict(n_kernels=5, kx=3, ky=3, padding=2, sliding=3)),
    ("MaxPooling", dict(kx=2, ky=2)),
    ("MaxPooling", dict(kx=3, ky=2, sliding=(2, 3))),
    ("MaxAbsPooling", dict(kx=2, ky=2)),
    ("AvgPooling", dict(kx=2, ky=2)),
    ("AvgPooling", dict(kx=3, ky=3, sliding=2)),
    ("LRNormalizerForward", dict()),
    ("LRNormalizerForward", dict(n=4, alpha=0.01, beta=0.5, k=1.0)),
    ("DropoutForward", dict(dropout_ratio=0.0)),
    ("ConvStrictRELU", dict(n_kernels=4, kx=3, ky=3, padding=1)),
    ("ConvSigmoid", dict(n_kernels=4, kx=2, ky=3, sliding=2, padding=1)),
    ("Conv", dict(n_kernels=3, kx=3, ky=2, sliding=2)),
]
_MODULES = ((JC, TC), (JP, TP), (JN, TN), (JD, TD))


def _classes(name):
    for jmod, tmod in _MODULES:
        if hasattr(jmod, name):
            return getattr(jmod, name), getattr(tmod, name)
    raise KeyError(name)


def _ids(case):
    name, kwargs = case
    return "%s-%s" % (name, "-".join("%s=%s" % kv
                                     for kv in sorted(kwargs.items())))


def port_pair(cls, kwargs, x_shape, params, gd_kwargs=None):
    """The port's forward (weights from the reference's ``params``) and
    its GD unit (learning rate 1, no momentum), on the CPU."""
    fwd = cls(**kwargs)
    fwd.initialize(x_shape, TorchDevice("cpu"))
    for key, value in params.items():
        setattr(fwd, key, torch.from_numpy(numpy.array(value)))
    gd = gradient_unit_for(cls)(**dict(gd_kwargs or {},
                                       learning_rate=1.0))
    gd.setup_forward(fwd)
    gd.initialize()
    return fwd, gd


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = numpy.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = numpy.abs(got.astype(numpy.float64) - want).max()
    assert diff <= atol, diff


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_unit_matches_reference(case):
    """Forward output, err_input and the updated parameters."""
    name, kwargs = case
    jcls, tcls = _classes(name)
    wf, feed, jf, jg, x, err, comp = build(jcls, gd_kwargs={}, **kwargs)
    params0 = comp.gather_params()
    want_y = xla_forward(comp, feed, jf, params0, x)
    want_ei, params1 = xla_backward(comp, feed, jf, jg, params0,
                                    comp.gather_state(), x, err)
    fwd, gd = port_pair(tcls, kwargs, x.shape, params0.get(jf.name, {}))
    fwd.train()
    xt = torch.from_numpy(x.astype(numpy.float32))
    y = fwd(xt)
    close(y, want_y)
    ei = gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32)))
    close(ei, want_ei)
    for key, value in params1.get(jf.name, {}).items():
        close(getattr(fwd, key), value)


def test_max_pooling_tie_routing():
    """Quantized input makes many equal values per window: the first
    maximum in window order wins in both packages, so the same input
    cells receive error (the same zero pattern), and the values agree
    (AlexNet's overlapping 3×3/s2 windows)."""
    wf, feed, jf, jg, x, err, comp = build(
        JP.MaxPooling, input_shape=(4, 9, 9, 3), gd_kwargs={},
        kx=3, ky=3, sliding=2)
    gen = jprng.get("tie")
    xq = (gen.randint(0, 3, x.shape) * 0.5).astype(numpy.float32)
    errq = gen.normal(0, 1.0, (4, 4, 4, 3)).astype(numpy.float32)
    params = comp.gather_params()
    want_y = numpy.asarray(xla_forward(comp, feed, jf, params, xq))
    want_ei, _ = xla_backward(comp, feed, jf, jg, params,
                              comp.gather_state(), xq, errq)
    want_ei = numpy.asarray(want_ei)
    fwd, gd = port_pair(TP.MaxPooling, dict(kx=3, ky=3, sliding=2),
                        xq.shape, {})
    y = fwd(torch.from_numpy(xq))
    assert numpy.array_equal(y.numpy(), want_y)
    ei = gd.run(torch.from_numpy(xq), y, torch.from_numpy(errq)).numpy()
    assert numpy.array_equal(ei == 0.0, want_ei == 0.0)
    close(ei, want_ei, 1e-6)


def test_stochastic_pooling_with_injected_uniforms():
    """Train mode with the reference's own uniforms (its per-unit key of
    the traced step) injected into the port: the same samples, winner
    offsets and routed error; eval mode: the same probability-weighted
    average."""
    kwargs = dict(kx=2, ky=2)
    wf, feed, jf, jg, x, err, comp = build(
        JP.StochasticPooling, input_shape=(3, 6, 6, 4), gd_kwargs={},
        **kwargs)
    params = comp.gather_params()
    ctx = FlowContext(comp, {}, {}, {}, jax.random.PRNGKey(7), True)
    u = numpy.array(jax.random.uniform(ctx.fold_key(jf), (3, 3, 3, 4)))
    want_train = xla_forward(comp, feed, jf, params, x, train=True)
    want_eval = xla_forward(comp, feed, jf, params, x, train=False)
    want_ei, _ = xla_backward(comp, feed, jf, jg, params,
                              comp.gather_state(), x, err)
    fwd, gd = port_pair(TP.StochasticPooling, kwargs, x.shape, {})
    fwd.uniform = lambda shape, device: torch.from_numpy(u)
    xt = torch.from_numpy(x.astype(numpy.float32))
    y = fwd.train()(xt)
    close(y, want_train)
    ei = gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32)))
    close(ei, want_ei)
    close(fwd.eval()(xt), want_eval)


def test_stochastic_pooling_draws_from_its_generator():
    """Without injection the uniforms come from the unit's own seeded
    generator: every sample is one of its window's values, and two units
    built at the same seed draw the same."""
    x = torch.from_numpy(numpy.random.default_rng(5).normal(
        0, 1, (2, 6, 6, 3)).astype(numpy.float32))
    outs = []
    for _ in range(2):
        tprng.seed_all(3)
        f = TP.StochasticPooling(kx=2, ky=2)
        f.initialize(x.shape, TorchDevice("cpu"))
        outs.append(f.train()(x))
        patches = f.patches(x)
        got = torch.gather(patches, 3, f.input_offset.long()[:, :, :, None,
                                                            :]).squeeze(3)
        assert torch.equal(got, outs[-1])
    assert torch.equal(outs[0], outs[1])


def test_dropout_with_injected_mask():
    """Ratio 0.4 in train mode: the reference's mask (its traced draw)
    injected into the port gives the same output and err_input; eval
    mode is the identity; the port's own mask keeps about 60%."""
    kwargs = dict(dropout_ratio=0.4)
    wf, feed, jf, jg, x, err, comp = build(
        JD.DropoutForward, input_shape=(16, 4, 4, 8), gd_kwargs={},
        **kwargs)

    def traced(xv):
        ctx = FlowContext(comp, {}, {}, {}, jax.random.PRNGKey(7), True)
        ctx.set(feed, "minibatch_data", xv)
        jf.xla_run(ctx)
        return ctx.get(jf, "output"), ctx.get(jf, "mask")

    want_y, mask = (numpy.array(t) for t in jax.jit(traced)(x))
    want_ei, _ = xla_backward(comp, feed, jf, jg, comp.gather_params(),
                              comp.gather_state(), x, err)
    fwd, gd = port_pair(TD.DropoutForward, kwargs, x.shape, {})
    xt = torch.from_numpy(x.astype(numpy.float32))
    own = fwd.train()(xt)
    assert abs((own != 0).float().mean().item() - 0.6) < 0.05
    fwd.draw_mask = lambda t: torch.from_numpy(mask)
    y = fwd(xt)
    close(y, want_y, 0.0)
    ei = gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32)))
    close(ei, want_ei, 0.0)
    assert fwd.eval()(xt) is xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_grad_at_conv_shape(dtype):
    """The relu (softplus) form at a conv GD's (B·oy·ox, K) view, AlexNet
    conv1 at the reduced geometry (8·15·15, 96), against the Pallas
    kernel in interpret mode: within 2e-4 (summation order)."""
    rng = numpy.random.default_rng(96)
    err = rng.normal(0, 1, (1800, 96)).astype(numpy.float32)
    y = rng.normal(0, 1, (1800, 96)).astype(numpy.float32)
    want = numpy.asarray(PG.bias_grad(jnp.asarray(err, dtype),
                                      jnp.asarray(y, dtype), "relu"))
    got = TBG.bias_grad(torch.from_numpy(err).to(getattr(torch, dtype)),
                        torch.from_numpy(y).to(getattr(torch, dtype)),
                        "relu")
    close(got, want, 2e-4)


def test_conv_math_matches_reference():
    """im2col/col2im and the channel-window sums against the
    reference's numpy versions, bit for bit (the same adds)."""
    from veles.znicz_tpu.ops import conv_math as JCM
    x = numpy.random.default_rng(4).normal(0, 1, (2, 7, 6, 5)) \
        .astype(numpy.float32)
    xt = torch.from_numpy(x)
    for ky, kx, stride, pads in ((3, 2, (2, 1), (1, 0, 2, 1)),
                                 (2, 2, (1, 1), (0, 0, 0, 0))):
        cols = JCM.im2col(numpy, x, ky, kx, stride, pads)
        tcols = TCM.im2col(xt, ky, kx, stride, pads)
        assert numpy.array_equal(tcols.numpy(), cols)
        back = JCM.col2im(numpy, cols, x.shape, ky, kx, stride, pads)
        close(TCM.col2im(tcols, x.shape, ky, kx, stride, pads), back, 1e-6)
    for window in (5, 4, 20):
        for reverse in (False, True):
            want = JCM.sliding_channel_sum(numpy, x, window, reverse)
            got = TCM.sliding_channel_sum(xt, window, reverse)
            close(got, want, 1e-5)
