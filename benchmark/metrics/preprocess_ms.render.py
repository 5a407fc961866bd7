"""Device ms a view under the program's das3r::preprocess range."""


def read(ctx):
    return ctx.stage_ms("das3r::preprocess")
