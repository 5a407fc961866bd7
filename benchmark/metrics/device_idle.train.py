"""Share of the traced training window with no operation on the device, in
%."""


def read(ctx):
    return ctx.idle_pct()
