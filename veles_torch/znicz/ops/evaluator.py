"""Loss evaluators of the PyTorch port.

Counterparts of ``EvaluatorSoftmax``, ``EvaluatorMSE`` and
``EvaluatorLM`` in ``veles/znicz_tpu/ops/evaluator.py``:

* :class:`EvaluatorSoftmax` — from softmax probabilities and integer
  labels, the fused softmax+CE gradient ``err_output = (p − onehot)/valid``
  and the minibatch metrics: mean cross-entropy ``loss``, wrong-count
  ``n_err``, and the worst valid row's loss ``max_err`` with its index;
  with ``compute_confusion`` it also adds each minibatch's (predicted,
  true) counts into ``confusion_matrix``, an int32 tensor on the device
  (no host sync per minibatch);
* :class:`EvaluatorMSE` — from any output and a target of the same
  size, ``err_output = 2·(y − t)/valid`` (no 1/D: the reference's
  learning rates are tuned to it) and the mean over valid rows of each
  row's mean squared error as ``loss``, the worst valid row's as
  ``max_err``; ``n_err`` is 0;
* :class:`EvaluatorLM` — next-token softmax cross-entropy over (B, S, V)
  logits with (B, S) labels, per token: ``err = (softmax −
  onehot)/(valid·S)`` and ``n_err`` = wrong token predictions.

All of it in f32. Rows at or past ``valid`` (the padding of a short last
minibatch) are masked out of the gradient and the metrics. Each returns
the metrics vector in the :data:`METRICS` layout, and names the loader
array it compares against in ``TARGET`` (``"labels"`` or
``"targets"``).

On a mesh (``veles_torch/znicz/parallel``) a rank sees its rows (and,
under sequence parallelism, its ``S/n`` positions) of the minibatch:
``valid`` is its own valid row count and ``total`` the minibatch's, by
which every mean and gradient is normalized (the LM's by ``total · S ·
seq_shards``), so the ranks' sums add up to the one-device values. The
step reduces the metrics over the ranks (``TorchStep``): sums summed,
the worst row's loss maxed and its index made global.
"""

import torch


def worst_row(per_sample, fmask):
    """(max, first-occurrence argmax) of a per-row loss over the valid
    rows, as the reference's ``_worst``."""
    masked = per_sample * fmask
    return masked.max(), torch.argmax(masked)


class EvaluatorSoftmax:
    """Fused softmax + cross-entropy loss."""

    TARGET = "labels"

    def __init__(self, name="evaluator", compute_confusion=False):
        self.name = name
        self.compute_confusion = compute_confusion
        #: (predicted, true) int32 counts over every minibatch run, on the
        #: device; made at the first minibatch
        self.confusion_matrix = None

    @staticmethod
    def compute(probs, labels, valid, total=None):
        """-> (err, loss, n_err, max_err, max_err_idx); ``valid`` is the
        true row count (a 0-d tensor or int), ``total`` the minibatch's
        on a mesh (default ``valid``)."""
        b, n_classes = probs.shape
        valid = torch.as_tensor(valid, device=probs.device)
        mask = torch.arange(b, device=probs.device) < valid
        fmask = mask.to(probs.dtype)
        denom = torch.as_tensor(valid if total is None else total,
                                device=probs.device).to(probs.dtype)
        onehot = (labels[:, None] == torch.arange(
            n_classes, device=probs.device)[None, :]).to(probs.dtype)
        err = (probs - onehot) * fmask[:, None] / denom
        p_true = torch.sum(probs * onehot, dim=-1)
        logp = torch.log(torch.clamp_min(p_true, 1e-30))
        loss = -torch.sum(logp * fmask) / denom
        max_idx = torch.argmax(probs, dim=-1)
        n_err = torch.sum((max_idx != labels) & mask)
        return (err, loss, n_err) + worst_row(-logp, fmask)

    def accumulate_confusion(self, probs, labels, valid):
        """Add the valid rows' (argmax, label) counts into
        ``confusion_matrix`` on the device."""
        b, n = probs.shape
        if self.confusion_matrix is None:
            self.confusion_matrix = torch.zeros(
                (n, n), dtype=torch.int32, device=probs.device)
        valid = torch.as_tensor(valid, device=probs.device)
        cell = torch.argmax(probs, dim=-1) * n + labels.long()
        ones = (torch.arange(b, device=probs.device) < valid) \
            .to(torch.int32)
        self.confusion_matrix.view(-1).scatter_add_(0, cell, ones)

    def run(self, probs, labels, valid, act_dtype, total=None):
        """-> (err_output in ``act_dtype``, metrics (4,) f32 tensor of
        loss, n_err, max_err, max_err_idx)."""
        probs = probs.to(torch.float32)
        err, loss, n_err, max_err, max_err_idx = self.compute(
            probs, labels, valid, total)
        if self.compute_confusion:
            self.accumulate_confusion(probs, labels, valid)
        metrics = torch.stack([loss, n_err.to(torch.float32), max_err,
                               max_err_idx.to(torch.float32)])
        return err.to(act_dtype), metrics


class EvaluatorMSE:
    """Mean squared error against a target array."""

    TARGET = "targets"

    def __init__(self, name="evaluator", root_metric=True):
        self.name = name
        #: accepted as the reference's option; like the reference, the
        #: metric is the MSE itself
        self.root_metric = root_metric

    @staticmethod
    def compute(y, t, valid, total=None):
        """-> (err (B, D), mse, max_err, max_err_idx) of f32 ``y`` and
        ``t`` viewed as (B, D) rows; ``valid`` is the true row count,
        ``total`` the minibatch's on a mesh (default ``valid``)."""
        b = y.shape[0]
        y2, t2 = y.reshape(b, -1), t.reshape(b, -1)
        valid = torch.as_tensor(valid, device=y.device).to(y2.dtype)
        denom = valid if total is None else torch.as_tensor(
            total, device=y.device).to(y2.dtype)
        fmask = (torch.arange(b, device=y.device) < valid).to(y2.dtype)
        diff = (y2 - t2) * fmask[:, None]
        err = 2.0 * diff / denom
        per_sample = torch.mean(diff * diff, dim=1)
        mse = torch.sum(per_sample) / denom
        return (err, mse) + worst_row(per_sample, fmask)

    def run(self, y, targets, valid, act_dtype, total=None):
        """-> (err_output shaped as ``y`` in ``act_dtype``, metrics (4,)
        f32 tensor of mse, 0, max_err, max_err_idx)."""
        err, mse, max_err, max_err_idx = self.compute(
            y.to(torch.float32), targets.to(torch.float32), valid, total)
        metrics = torch.stack([mse, torch.zeros_like(mse), max_err,
                               max_err_idx.to(torch.float32)])
        return err.reshape(y.shape).to(act_dtype), metrics


class EvaluatorLM:
    """Next-token softmax cross-entropy over (B, S, V) logits."""

    TARGET = "labels"

    def __init__(self, name="evaluator"):
        self.name = name
        #: the ranks the sequence is sharded over (each holds S/n of it)
        self.seq_shards = 1

    @staticmethod
    def compute(logits, labels, valid, total=None, seq_shards=1):
        """-> (err, loss, n_err) from f32 ``logits`` (B, S, V) and integer
        ``labels`` (B, S); ``valid`` is the true row count, ``total`` the
        minibatch's on a mesh (default ``valid``), ``seq_shards`` the
        ranks the sequence is split over."""
        b, s, _ = logits.shape
        z = logits - logits.amax(dim=-1, keepdim=True)
        logp = z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))
        labels = labels.long()[..., None]
        valid = torch.as_tensor(valid, device=logits.device)
        rowmask = (torch.arange(b, device=logits.device) < valid) \
            .to(logits.dtype)
        denom = torch.as_tensor(valid if total is None else total,
                                device=logits.device).to(logits.dtype) \
            * float(s * seq_shards)
        # probs − onehot without a (B, S, V) one-hot: subtract 1 at the
        # label (the same f32 operation)
        err = torch.exp(logp).scatter_add_(
            -1, labels, torch.full(labels.shape, -1.0, dtype=logits.dtype,
                                   device=logits.device))
        err = err * rowmask[:, None, None] / denom
        loss = -logp.gather(-1, labels).squeeze(-1)
        loss = (loss * rowmask[:, None]).sum() / denom
        pred = torch.argmax(logits, dim=-1)
        wrong = ((pred != labels.squeeze(-1))
                 & (rowmask[:, None] > 0)).sum()
        return err, loss, wrong

    def run(self, logits, labels, valid, act_dtype, total=None):
        """-> (err_output in ``act_dtype``, metrics (4,) f32 tensor of
        loss, n_err, 0, 0: the LM has no max-error row)."""
        err, loss, wrong = self.compute(logits.to(torch.float32), labels,
                                        valid, total, self.seq_shards)
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        metrics = torch.stack([loss, wrong.to(torch.float32), zero, zero])
        return err.to(act_dtype), metrics


#: order of the metrics vector returned by the evaluators' ``run``
METRICS = ("loss", "n_err", "max_err", "max_err_idx")
