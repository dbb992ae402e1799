"""The attention units' share of their roofline in a train step: the least
time of the work they need (qkv and out projections and the causal core,
forward and backward, and their updates' bytes) over the device time of
everything their forward and GD calls launch."""

import yardstick


def read(ctx):
    flops, nbytes = yardstick.lm_attention_step_work(
        ctx.cell.config["model"], ctx.cell.traffic)
    return ctx.roofline_pct("bench.attn", flops, nbytes)
