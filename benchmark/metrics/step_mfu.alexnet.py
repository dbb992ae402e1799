"""The whole train step's share of the bf16 dense peak (AlexNet)."""


def read(ctx):
    return ctx.mfu_pct()
