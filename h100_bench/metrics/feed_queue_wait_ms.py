"""feed_queue_wait_ms: the host's ms a traced step in the program's
``dmt.feed.queue`` span, the loop's thread waiting for the loader's read
thread: where it is above 0, reading the files sets the pace."""

import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "dmt.feed.queue")
