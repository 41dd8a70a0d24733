"""feed_sync_ms: the host's ms a traced step in the program's
``dmt.feed.sync`` spans: the feed's copies to the device that are ordered
on the step's stream (index rows, labels, the pinned copy of a host
batch), so the loop's thread waits there for the device's queue. Where the
device is the slower side this reads about a step; it is the host held in
the feed by the device."""

import program_trace


def read(ctx):
    return program_trace.span_ms(ctx, "dmt.feed.sync")
