"""Device ms a frame under the benchmark's bench::encode range around the
model's encode (set in traced runs only)."""


def read(ctx):
    frames = ctx.work.get("frames")
    s = ctx.trace.spans_s.get("bench::encode", 0.0)
    return s * 1e3 / frames if frames and s > 0 else None
