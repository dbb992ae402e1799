"""The whole train step's share of the bf16 dense peak (the LM)."""


def read(ctx):
    return ctx.mfu_pct()
