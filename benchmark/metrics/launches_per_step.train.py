"""Device records (kernels, copies, fills) per training step in the traced
window."""


def read(ctx):
    return (ctx.trace.launches / ctx.units) if ctx.units else None
