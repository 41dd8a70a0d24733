"""device_idle_share: the share of the traced window, in %, in which
nothing ran on the device: 1 - busy / wall."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["idle_share"] is None:
        return None
    return tr["idle_share"] * 100
