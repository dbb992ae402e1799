"""Cross-entropy evaluators of the PyTorch port.

Counterparts of ``EvaluatorSoftmax`` and ``EvaluatorLM`` in
``veles/znicz_tpu/ops/evaluator.py``:

* :class:`EvaluatorSoftmax` — from softmax probabilities and integer
  labels, the fused softmax+CE gradient ``err_output = (p − onehot)/valid``
  and the minibatch metrics: mean cross-entropy ``loss``, wrong-count
  ``n_err``, and the worst valid row's loss ``max_err`` with its index;
* :class:`EvaluatorLM` — next-token softmax cross-entropy over (B, S, V)
  logits with (B, S) labels, per token: ``err = (softmax −
  onehot)/(valid·S)`` and ``n_err`` = wrong token predictions.

All of it in f32. Rows at or past ``valid`` (the padding of a short last
minibatch) are masked out of the gradient and the metrics. Both return
the metrics vector in the :data:`METRICS` layout.
"""

import torch


class EvaluatorSoftmax:
    """Fused softmax + cross-entropy loss."""

    def __init__(self, name="evaluator"):
        self.name = name

    @staticmethod
    def compute(probs, labels, valid):
        """-> (err, loss, n_err, max_err, max_err_idx); ``valid`` is the
        true row count (a 0-d tensor or int)."""
        b, n_classes = probs.shape
        valid = torch.as_tensor(valid, device=probs.device)
        mask = torch.arange(b, device=probs.device) < valid
        fmask = mask.to(probs.dtype)
        denom = valid.to(probs.dtype)
        onehot = (labels[:, None] == torch.arange(
            n_classes, device=probs.device)[None, :]).to(probs.dtype)
        err = (probs - onehot) * fmask[:, None] / denom
        p_true = torch.sum(probs * onehot, dim=-1)
        logp = torch.log(torch.clamp_min(p_true, 1e-30))
        loss = -torch.sum(logp * fmask) / denom
        max_idx = torch.argmax(probs, dim=-1)
        n_err = torch.sum((max_idx != labels) & mask)
        # first-occurrence argmax, as the reference
        worst = -logp * fmask
        return err, loss, n_err, worst.max(), torch.argmax(worst)

    def run(self, probs, labels, valid, act_dtype):
        """-> (err_output in ``act_dtype``, metrics (4,) f32 tensor of
        loss, n_err, max_err, max_err_idx)."""
        err, loss, n_err, max_err, max_err_idx = self.compute(
            probs.to(torch.float32), labels, valid)
        metrics = torch.stack([loss, n_err.to(torch.float32), max_err,
                               max_err_idx.to(torch.float32)])
        return err.to(act_dtype), metrics


class EvaluatorLM:
    """Next-token softmax cross-entropy over (B, S, V) logits."""

    def __init__(self, name="evaluator"):
        self.name = name

    @staticmethod
    def compute(logits, labels, valid):
        """-> (err, loss, n_err) from f32 ``logits`` (B, S, V) and integer
        ``labels`` (B, S); ``valid`` is the true row count."""
        b, s, _ = logits.shape
        z = logits - logits.amax(dim=-1, keepdim=True)
        logp = z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))
        labels = labels.long()[..., None]
        valid = torch.as_tensor(valid, device=logits.device)
        rowmask = (torch.arange(b, device=logits.device) < valid) \
            .to(logits.dtype)
        denom = valid.to(logits.dtype) * float(s)
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

    def run(self, logits, labels, valid, act_dtype):
        """-> (err_output in ``act_dtype``, metrics (4,) f32 tensor of
        loss, n_err, 0, 0: the LM has no max-error row)."""
        err, loss, wrong = self.compute(logits.to(torch.float32), labels,
                                        valid)
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        metrics = torch.stack([loss, wrong.to(torch.float32), zero, zero])
        return err.to(act_dtype), metrics


#: order of the metrics vector returned by the evaluators' ``run``
METRICS = ("loss", "n_err", "max_err", "max_err_idx")
