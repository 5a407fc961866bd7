"""Counted matmul and convolution operations of the traced pairs over the
window x 67 TFLOP/s, in %."""


def read(ctx):
    return ctx.mfu_pct()
