"""Rank 0's device ms a pair under the program's ``das3r::decode`` range
outside ``das3r::heads``: the two frozen ViT-B decoders and the casts of
their tokens for the heads (8 pairs a step)."""


def read(ctx):
    pairs = ctx.work.get("pairs")
    s = ctx.trace.stage_s.get("das3r::decode")
    if not pairs or not s or s["forward"] <= 0:
        return None
    return (s["forward"] + s["backward"]) * 1e3 / pairs
