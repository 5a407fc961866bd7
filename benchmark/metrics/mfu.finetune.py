"""Rank 0's counted operations of the traced steps (its encodes, decodes
with the four heads, and the mask heads' backward) over its device-only
window x 67 TFLOP/s, in %."""


def read(ctx):
    return ctx.mfu_pct()
