"""Counted FP32 operations of the traced orbit views over the window x 67
TFLOP/s, in %."""


def read(ctx):
    return ctx.mfu_pct()
