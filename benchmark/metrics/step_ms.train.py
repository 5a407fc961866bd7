"""Host-clock milliseconds per training step over the traced run's
untraced window: every step of whole ``train_chunk`` calls for
``--seconds``, no profiler on (what ``splat_step_device_ms`` adds the
host's dispatch to)."""


def read(ctx):
    return ctx.e2e.get("step_ms")
