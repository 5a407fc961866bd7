"""Rank 0's device ms a frame under the program's ``das3r::encode``
range: the frozen ViT-L encoder, forward only (16 frames a step)."""


def read(ctx):
    frames = ctx.work.get("frames")
    s = ctx.trace.stage_s.get("das3r::encode")
    if not frames or not s or s["forward"] <= 0:
        return None
    return (s["forward"] + s["backward"]) * 1e3 / frames
