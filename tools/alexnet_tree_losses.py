"""AlexNet (the ImageNet sample at full width) streamed 2 epochs from
``chip_smoke.py``'s JPEG tree at several learning rates, with every train
step's metrics row (loss, errors) read back: where the sample's training
on that tree spikes and where it does not.

    python tools/alexnet_tree_losses.py [LR ...]     (default 0.01 0.001)

Runs on the card (``-d cuda``) and needs the kernels built
(``veles_torch.kernels.build``, done here). Each run is one JSON line in
``alexnet_tree_losses.jsonl`` in chip_smoke.py's output directory and on
standard output: the learning rate, the card, each train step's metrics
row, the epochs' train and validation losses and validation error, the
seconds.
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


def lr_runs(lrs):
    """One 2-epoch CLI run of the sample on the JPEG tree for each
    learning rate of ``lrs``, each emitted as a ``probe_lr`` line."""
    from veles_torch.config import root
    from veles_torch.znicz.step import TorchStep
    rec = []
    orig = TorchStep._minibatch

    def mb(self, step, fetch, train, valid, metrics, i, stats, j):
        out = orig(self, step, fetch, train, valid, metrics, i, stats, j)
        if train:
            rec.append(metrics[i].tolist())
        return out
    TorchStep._minibatch = mb
    tmp = tempfile.mkdtemp(prefix="jpeg_lr_", dir=C.OUT_DIR)
    saved = root.imagenet.loader.to_dict()
    saved_lr = root.imagenet.lr
    try:
        C.write_jpeg_tree(os.path.join(tmp, "tree"))
        for lr in lrs:
            del rec[:]
            t0 = time.perf_counter()
            wf = C.cli_run([C.IMAGENET_SAMPLE,
                            "root.imagenet.loader.base_dir=%s"
                            % os.path.join(tmp, "tree"),
                            "root.imagenet.decision.max_epochs=2",
                            "root.imagenet.lr=%g" % lr, "--seed", "1337",
                            "-d", "cuda"])
            C.emit({"phase": "probe_lr", "card": C.card_line(), "lr": lr,
                    "step_metrics": list(rec),
                    "train_loss": [h["train"]["loss"]
                                   for h in wf.decision.history],
                    "validation_loss": [h["validation"].get("loss")
                                        for h in wf.decision.history],
                    "validation_error": [h["validation"]["metric"]
                                         for h in wf.decision.history],
                    "seconds": time.perf_counter() - t0})
            root.imagenet.loader.update(saved)
            root.imagenet.lr = saved_lr
    finally:
        TorchStep._minibatch = orig
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv):
    from veles_torch import kernels
    lrs = [float(a) for a in argv] or [0.01, 0.001]
    C.LOG_PATH = os.path.join(C.OUT_DIR, "alexnet_tree_losses.jsonl")
    os.makedirs(C.OUT_DIR, exist_ok=True)
    open(C.LOG_PATH, "w").close()
    kernels.build()
    lr_runs(lrs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
