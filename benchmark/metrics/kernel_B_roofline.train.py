"""Kernel B's share of its roofline over the traced training window: the
least time of the frozen count (benchmark/work/splat.py) over B's device
time, in %."""


def read(ctx):
    return ctx.roofline_pct("blend_forward_kernel", "B")
