"""Device ms a step under the program's das3r::adam range."""


def read(ctx):
    return ctx.stage_ms("das3r::adam", backward=False)
