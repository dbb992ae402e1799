"""Host calls that put work on the card (kernel and graph launches,
copies, fills) per AlexNet train step, from the profiler's runtime and
driver events."""


def read(ctx):
    return ctx.launches_per_step()
