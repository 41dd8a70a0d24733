"""step_busy_ms: the device's busy time a step, in ms: the union of the
device's activity in the traced steps over their number."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] / tr["steps"] * 1e3
