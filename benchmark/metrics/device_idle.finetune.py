"""Share of rank 0's traced device-only window (a pass over the pool)
with no operation on its card, in %."""


def read(ctx):
    return ctx.idle_pct()
