"""Rank 0's device ms a step under the program's ``das3r::heads`` range,
forward and backward: the four DPT heads and the mask heads'
gradients."""


def read(ctx):
    v = ctx.stage_ms("das3r::heads")
    return v if v else None
