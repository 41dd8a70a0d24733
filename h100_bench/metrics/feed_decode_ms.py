"""feed_decode_ms: the host's ms a traced step in the program's
``dmt.feed.decode`` span (nvJPEG's decode and the resize, on the loop's
thread)."""

import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "dmt.feed.decode")
