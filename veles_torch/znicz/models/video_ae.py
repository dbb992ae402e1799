"""VideoAE sample of the PyTorch port: a frame autoencoder over a
synthetic moving-pattern video corpus.

Counterpart of ``veles/znicz_tpu/models/video_ae.py`` with the same
``root.video_ae`` defaults: MnistAE's conv → pool → depool → deconv
stack (8 kernels) over the 24×24 frames of 40 clips × 16 frames, each
clip a Gaussian blob orbiting on its own path, drawn from the same fixed
generator as the reference (the same frames bit for bit); minibatch 50,
5 epochs. Validation holds out whole clips (the first fifth), since
frames of one clip share their look.
"""

import numpy

from veles_torch.config import root
from veles_torch.loader.fullbatch import FullBatchLoader
from veles_torch.znicz.standard_workflow import StandardWorkflow

root.video_ae.update({
    "loader": {"minibatch_size": 50, "n_clips": 40,
               "frames_per_clip": 16, "frame_size": 24,
               "valid_ratio": 0.2},
    "layers": [
        {"type": "conv_tanh",
         "->": {"n_kernels": 8, "kx": 5, "ky": 5},
         "<-": {"learning_rate": 0.002, "gradient_moment": 0.5}},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "depooling", "->": {"output_shape_source": 1}},
        # see mnist_ae: the deconv's spatial-sum gradient needs a tiny lr
        {"type": "deconv",
         "->": {"n_kernels": 8, "kx": 5, "ky": 5,
                "output_shape_source": 0},
         "<-": {"learning_rate": 2e-5, "gradient_moment": 0.5}},
    ],
    "decision": {"max_epochs": 5, "fail_iterations": 20},
})


class VideoFramesLoader(FullBatchLoader):
    """Synthetic clips, frame in, frame out; validation holds out whole
    clips."""

    def load_data(self):
        cfg = root.video_ae.loader
        n_clips = cfg.get("n_clips", 40)
        fpc = cfg.get("frames_per_clip", 16)
        size = cfg.get("frame_size", 24)
        gen = numpy.random.Generator(numpy.random.PCG64(0x51DE0))
        yy, xx = numpy.mgrid[0:size, 0:size]
        frames = numpy.empty((n_clips, fpc, size, size, 1), numpy.float32)
        for c in range(n_clips):
            cx, cy = gen.uniform(size * 0.3, size * 0.7, 2)
            radius = gen.uniform(size * 0.1, size * 0.25)
            phase = gen.uniform(0, 2 * numpy.pi)
            sigma = gen.uniform(1.5, 3.0)
            for f in range(fpc):
                a = phase + 2 * numpy.pi * f / fpc
                bx = cx + radius * numpy.cos(a)
                by = cy + radius * numpy.sin(a)
                frames[c, f, :, :, 0] = numpy.exp(
                    -((xx - bx) ** 2 + (yy - by) ** 2) / (2 * sigma ** 2))
        n_valid = max(1, int(n_clips * cfg.get("valid_ratio", 0.2)))
        valid = frames[:n_valid].reshape(-1, size, size, 1)
        train = frames[n_valid:].reshape(-1, size, size, 1)
        self.original_data = self.original_targets = \
            numpy.concatenate([valid, train])
        self.class_lengths = [0, len(valid), len(train)]


def create_workflow(name="VideoAEWorkflow"):
    cfg = root.video_ae
    return StandardWorkflow(
        name=name, layers=cfg.layers,
        loader_factory=lambda wf: VideoFramesLoader(
            wf, name="loader", minibatch_size=cfg.loader.minibatch_size),
        decision_config=cfg.decision.to_dict())
