"""Kernel B's share of its roofline over the traced orbit window, in %."""


def read(ctx):
    return ctx.roofline_pct("blend_forward_kernel", "B")
