"""Counted FP32 operations of the traced training steps over the window x
67 TFLOP/s, in %."""


def read(ctx):
    return ctx.mfu_pct()
