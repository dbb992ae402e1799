"""The share of the traced window in which no device work ran
(AlexNet)."""


def read(ctx):
    return ctx.idle_pct()
