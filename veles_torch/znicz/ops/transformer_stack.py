"""The stacked transformer-block unit pair of the port.

Counterpart of ``veles/znicz_tpu/ops/transformer_stack.py``: ONE unit
owning ``layers`` identical post-LN blocks (MHA + residual -> LN -> FFN
+ residual -> LN, the block the per-layer LM builds from attention,
layernorm and transformer_ffn units), every parameter stacked along a
leading layer dimension under the reference's names. The math is
``parallel/pipeline.py``'s; attention inside the stack is the dense
formulation. Eager PyTorch walks the layers in a Python loop.

``x`` is cast to f32 at the stack's boundary, as the reference's scan
carry is. ``remat=True`` keeps only each layer's input through the
forward and recomputes a layer's cache in the backward (one more block
forward per layer) instead of holding every layer's (B, H, S, S)
probabilities; the step is bit for bit the same.

Pipeline parallelism (``parallel.setup_pipeline_parallel``: ``pipe_mesh``
set): the rank holds its stage's ``L/P`` blocks and runs the schedule
``pipe_schedule`` over ``pipe_microbatches`` microbatches
(``parallel/pipeline.py``):

* ``"gpipe"``: the train forward stashes every microbatch's caches, the
  GD unit replays them backward;
* ``"1f1b"`` with a foldable loss tail (``pipe_tail``: every unit between
  the stack and the evaluator has ``tail_fwd``/``tail_bwd`` and the
  evaluator ``mb_loss_grad``, as the stacked LM's token_dense and
  EvaluatorLM): the train forward runs the whole interleaved schedule,
  the tail and the loss gradient as the last stage's ``err_fn`` on the
  minibatch's labels (``pipe_tail["step"].fold_target``, pad rows marked
  by the ``-1`` label), so a train step runs ONE pipelined forward; the GD
  unit takes its dx and gradients;
* ``"1f1b"`` unfoldable: the forward runs un-stashed and the GD unit
  reruns the schedule with the error it is handed (two forwards);
* eval runs the un-stashed forward under either schedule.
"""

import numpy
import torch

from veles_torch.znicz.nn_units import (
    Forward, GradientDescentBase, forward_unit, gradient_for)
from veles_torch.znicz.parallel import pipeline as PL


@forward_unit("transformer_stack")
class TransformerBlockStack(Forward):
    """N identical transformer blocks with stacked (L, ...) params."""

    PARAMS = PL.PARAMS

    def __init__(self, layers=None, heads=4, hidden=None, causal=True,
                 eps=1e-5, remat=False, **kwargs):
        super().__init__(**kwargs)
        if not layers:
            raise ValueError("transformer_stack needs layers >= 1")
        self.layers = int(layers)
        self.heads = int(heads)
        self.hidden = hidden
        self.causal = causal
        self.eps = float(eps)
        self.remat = bool(remat)
        #: the forward's stash for the GD unit: a cache per layer, or
        #: with ``remat`` each layer's input; under PP the schedule's
        self.cache = None
        #: set by parallel.setup_pipeline_parallel (module docstring)
        self.pipe_mesh = None
        self.pipe_axis = "pipe"
        self.pipe_microbatches = 4
        self.pipe_schedule = "gpipe"
        self.pipe_tail = None

    def initialize(self, input_shape, device):
        self.device = device
        _, _, d = input_shape
        if d % self.heads:
            raise ValueError("dim %d not divisible by %d heads"
                             % (d, self.heads))
        n, h = self.layers, self.hidden or 4 * d
        self.hidden = h

        def filled(shape, fan_in, fan_out):
            arr = numpy.zeros(shape, numpy.float32)
            self.fill_array(arr, self.weights_filling,
                            self.weights_stddev
                            or self.default_weights_stddev(fan_in, fan_out))
            return arr

        # the reference's fill order: the numpy generator's draws match
        host = {"weights": filled((n, d, 3 * d), d, 3 * d),
                "bias": numpy.zeros((n, 3 * d), numpy.float32),
                "weights_out": filled((n, d, d), d, d),
                "bias_out": numpy.zeros((n, d), numpy.float32),
                "ln1_g": numpy.ones((n, d), numpy.float32),
                "ln1_b": numpy.zeros((n, d), numpy.float32),
                "ffn_w1": filled((n, d, h), d, h),
                "ffn_b1": numpy.zeros((n, h), numpy.float32),
                "ffn_w2": filled((n, h, d), h, d),
                "ffn_b2": numpy.zeros((n, d), numpy.float32),
                "ln2_g": numpy.ones((n, d), numpy.float32),
                "ln2_b": numpy.zeros((n, d), numpy.float32)}
        for name in self.PARAMS:
            setattr(self, name, torch.as_tensor(host[name]).to(
                device.device))
        return tuple(input_shape)

    def params(self):
        return {name: getattr(self, name) for name in self.PARAMS}

    def pipe_kwargs(self):
        return {"mesh": self.pipe_mesh, "axis": self.pipe_axis,
                "n_micro": self.pipe_microbatches, "heads": self.heads,
                "eps": self.eps, "dot": self.device.dot}

    def forward(self, x):
        x = x.to(torch.float32)
        if self.pipe_mesh is None:
            run = PL.stack_fwd_remat if self.remat else PL.stack_fwd
            y, self.cache = run(self.params(), x, self.heads, self.causal,
                                self.eps, self.device.dot)
        elif self.training and self.pipe_schedule == "1f1b" \
                and self.pipe_tail is not None:
            y, dx, grads, _ = PL.pipeline_1f1b_step(
                self.params(), x, *self._fold(x), causal=self.causal,
                **self.pipe_kwargs())
            self.cache = (dx, grads)
        else:
            stash = self.training and self.pipe_schedule == "gpipe"
            y, self.cache = PL.pipeline_fwd(
                self.params(), x, causal=self.causal, stash=stash,
                **self.pipe_kwargs())
        return y.to(self.device.act_dtype)

    def _fold(self, x):
        """(targets, err_fn) of the folded 1F1B step: the labels with pad
        rows at -1, and the tail and the loss gradient of a microbatch
        with the minibatch's denominator (valid rows · S) in it."""
        tail, ev = self.pipe_tail["units"], self.pipe_tail["evaluator"]
        labels, valid = self.pipe_tail["step"].fold_target
        mine, total = valid if isinstance(valid, tuple) else (valid, valid)
        rows = torch.arange(labels.shape[0], device=labels.device)
        targets = torch.where((rows < mine)[:, None], labels.long(), -1)
        inv_denom = 1.0 / (torch.as_tensor(total, device=x.device).to(
            torch.float32) * float(labels.shape[1]))
        act = self.device.act_dtype

        def err_fn(y_mb, labels_mb):
            h, ys = y_mb.to(act), []
            for u in tail:
                h = u.tail_fwd(h)
                ys.append(h)
            err, loss = ev.mb_loss_grad(h.to(torch.float32), labels_mb,
                                        inv_denom)
            e = err.to(act)
            for u, y in zip(reversed(tail), reversed(ys)):
                e = u.tail_bwd(y, e)
            return e.to(torch.float32), loss
        return targets, err_fn


@gradient_for(TransformerBlockStack)
class GDTransformerBlockStack(GradientDescentBase):
    """Reverse loop over the layers (recomputing each layer's cache with
    ``remat``); the weights/bias update and every other parameter's in
    lockstep through ``EXTRA_PARAMS``."""

    EXTRA_PARAMS = (("weights_out", False), ("bias_out", True),
                    ("ln1_g", False), ("ln1_b", True),
                    ("ffn_w1", False), ("ffn_b1", True),
                    ("ffn_w2", False), ("ffn_b2", True),
                    ("ln2_g", False), ("ln2_b", True))

    def run(self, x, y, err):
        f = self.forward
        dev = f.device
        x = x.to(torch.float32)
        err = err.reshape(x.shape).to(torch.float32)
        if f.pipe_mesh is not None:
            dx, grads = self._pipe_backward(x, err)
        elif f.remat:
            dx, grads = PL.stack_bwd_remat(f.params(), f.cache, err,
                                           f.heads, f.causal, f.eps,
                                           dev.dot)
        else:
            dx, grads = PL.stack_bwd(f.params(), f.cache, err, f.heads,
                                     f.eps, dev.dot)
        f.cache = None
        self.update_weights(grads["weights"], grads["bias"])
        self.update_extra(grads)
        return dx.to(dev.act_dtype) if self.need_err_input else None

    def _pipe_backward(self, x, err):
        f = self.forward
        if f.pipe_schedule == "gpipe":
            return PL.pipeline_bwd(f.params(), f.cache, err,
                                   **f.pipe_kwargs())
        if f.cache is not None:             # the folded step's
            return f.cache
        _, dx, grads, _ = PL.pipeline_1f1b_step(
            f.params(), x, err, lambda y_mb, e_mb: (e_mb, 0.0),
            causal=f.causal, **f.pipe_kwargs())
        return dx, grads
