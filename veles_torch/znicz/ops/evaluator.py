"""Softmax cross-entropy evaluator of the PyTorch port.

Counterpart of ``EvaluatorSoftmax`` in
``veles/znicz_tpu/ops/evaluator.py``: from softmax probabilities and
integer labels it emits the fused softmax+CE gradient ``err_output =
(p − onehot)/valid`` and the minibatch metrics — mean cross-entropy
``loss``, wrong-count ``n_err``, and the worst valid row's loss
``max_err`` with its index. All of it in f32. Rows at or past ``valid``
(the padding of a short last minibatch) are masked out of the gradient
and the metrics.
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


#: order of the metrics vector returned by :meth:`EvaluatorSoftmax.run`
METRICS = ("loss", "n_err", "max_err", "max_err_idx")
