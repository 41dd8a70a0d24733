"""feed_wait_ms: the host's wait on the data feed, in ms a step: the host
clock around each ``next()`` on the trainer's loader, the mean over the
window's steps (an epoch's end and the next epoch's first batch
included)."""


def read(ctx):
    waits = ctx["window"]["feed_waits_s"]
    return sum(waits) / len(waits) * 1e3 if waits else None
