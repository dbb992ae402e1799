"""TorchStep — runs the training cycle of a workflow on its device.

Counterpart of ``StepCompiler``/``build_epoch_scan``
(``veles/accelerated_units.py``) and ``XLAStep``
(``veles/znicz_tpu/xla_step.py``). A train step is forward -> evaluator
-> reversed GD chain with its updates; an eval step is forward ->
evaluator. An epoch walks the loader's class schedule in serving order
(valid before train): the dataset stays on the device and every
minibatch is gathered there by index; each class's per-minibatch
metrics stay on the device until the class ends and come to the host in
one copy, which is then handed to the decision minibatch by minibatch.

Eager PyTorch: each operation is its own launch (no CUDA graph yet).
"""

import time

import torch

from veles_torch.loader.base import CLASS_TRAIN, CLASS_VALID
from veles_torch.znicz.ops.evaluator import METRICS


class TorchStep:
    """Runs the forward/evaluator/GD units of one workflow."""

    def __init__(self, loader, forwards, evaluator, gds, decision, device):
        self.loader = loader
        self.forwards = list(forwards)
        self.evaluator = evaluator
        self.gds = list(gds)
        self.decision = decision
        self.device = device
        #: train minibatches run so far
        self.train_steps = 0
        #: host seconds of each finished epoch (metric fetches included)
        self.epoch_seconds = []

    def _forward(self, data):
        """-> the input of every forward, and the last output."""
        inputs = []
        x = data
        for f in self.forwards:
            inputs.append(x)
            x = f(x)
        return inputs, x

    def eval_minibatch(self, data, labels, valid):
        """Forward + evaluator; -> the (4,) metrics tensor."""
        _, probs = self._forward(data)
        _, metrics = self.evaluator.run(probs, labels, valid,
                                        self.device.act_dtype)
        return metrics

    def train_minibatch(self, data, labels, valid):
        """One train step with its updates; -> the (4,) metrics tensor."""
        inputs, probs = self._forward(data)
        err, metrics = self.evaluator.run(probs, labels, valid,
                                          self.device.act_dtype)
        outputs = inputs[1:] + [probs]
        for i in reversed(range(len(self.gds))):
            err = self.gds[i].run(inputs[i], outputs[i], err)
        self.train_steps += 1
        return metrics

    def run_epoch(self):
        """Serve every class of the loader's current epoch and feed the
        decision."""
        t0 = time.perf_counter()
        loader = self.loader
        dev = self.device.device
        full = loader.device_full_arrays(dev)
        plan = loader.epoch_plan()
        has_valid = loader.class_lengths[CLASS_VALID] > 0
        for ci, (cls, idx_mat, valids) in enumerate(plan):
            step = self.train_minibatch if cls == CLASS_TRAIN \
                else self.eval_minibatch
            idx = torch.as_tensor(idx_mat, dtype=torch.int64).to(dev)
            valid_dev = torch.as_tensor(valids).to(dev)
            metrics = torch.empty((len(idx_mat), len(METRICS)),
                                  dtype=torch.float32, device=dev)
            for i in range(len(idx_mat)):
                metrics[i] = step(
                    torch.index_select(full["data"], 0, idx[i]),
                    torch.index_select(full["labels"], 0, idx[i]),
                    valid_dev[i])
            host = metrics.cpu().numpy()
            last_cls = ci == len(plan) - 1
            for i, row in enumerate(host):
                last = i == len(host) - 1
                self.decision.on_minibatch(
                    cls, int(valids[i]), int(row[1]), float(row[0]),
                    last_minibatch=last, epoch_ended=last and last_cls,
                    has_valid=has_valid)
        self.epoch_seconds.append(time.perf_counter() - t0)
