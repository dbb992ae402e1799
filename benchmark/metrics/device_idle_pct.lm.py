"""The share of the traced window in which no device work ran (the LM)."""


def read(ctx):
    return ctx.idle_pct()
