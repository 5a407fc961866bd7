"""Kernel C's share of its roofline over the traced training window, in %."""


def read(ctx):
    return ctx.roofline_pct("blend_backward_kernel", "C")
