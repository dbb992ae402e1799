"""Host calls that put work on the card (kernel and graph launches,
copies, fills) per train step of the LM, from the profiler's runtime and
driver events."""


def read(ctx):
    return ctx.launches_per_step()
