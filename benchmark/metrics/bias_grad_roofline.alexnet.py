"""The bias-gradient sums' share of their roofline in a train step: the
bytes they need (bf16 error and output read once, f32 sums written) over
the device time of everything the sums launch."""

import yardstick


def read(ctx):
    nbytes = yardstick.alexnet_bias_grad_step_bytes(
        ctx.cell.config["model"], ctx.cell.traffic)
    return ctx.roofline_pct("bench.bias_grad", nbytes / 2, nbytes)
