"""Device ms a step under the program's das3r::preprocess range, its
backward included (operators by autograd sequence number)."""


def read(ctx):
    return ctx.stage_ms("das3r::preprocess")
