"""Device ms a view under the program's das3r::bin_entry_stream range
(sorted_key_stream and entry_stream_from_keys)."""


def read(ctx):
    return ctx.stage_ms("das3r::bin_entry_stream")
