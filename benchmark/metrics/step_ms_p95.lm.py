"""The 95th percentile of the LM's train step times (CUDA events at each
step's start, consecutive train steps of a class) in the untraced rest of
the traced run's window."""

import numpy


def read(ctx):
    if len(ctx.step_ms) < 2:
        return None
    return float(numpy.percentile(ctx.step_ms, 95))
