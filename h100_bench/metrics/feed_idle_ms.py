"""feed_idle_ms: the device's idle time a step, in ms, while the host was
in the data feed (inside ``next()`` on the trainer's loader), from the
traced steps: the time the step's work waited for the feed. Where the
device is the slower side, the loop's thread also waits inside the feed
for the device's queue, so feed_wait_ms reads about a step, and this
reads near 0."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return tr["idle_s_by_span"].get("feed", 0.0) / tr["steps"] * 1e3
