"""Device ms a pair under the benchmark's bench::decode range around the
model's decode and heads (traced runs only)."""


def read(ctx):
    return ctx.per_unit_ms(ctx.trace.spans_s.get("bench::decode", 0.0))
