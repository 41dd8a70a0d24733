"""batchnorm_roofline: the BatchNorm kernels' share of their byte
roofline, in %: the bytes the step's BatchNorm calls have to move (each
call of the reference's ``batchnorm_calls``, rows × C elements: x in and y
out forward, x and dy in and dx out backward, 4 and 6 B an element in
bf16) at 3.35 TB/s, times the traced steps, over the device time of the
kernels whose names carry ``dmt_bn`` (``csrc/batchnorm.cu``) in those
steps. Nothing is read for a reference without ``batchnorm_calls``, or
when no such kernel ran."""

FWD_BYTES, BWD_BYTES = 4, 6


def read(ctx):
    tr, costs = ctx.get("trace"), ctx["costs"]
    calls = getattr(ctx["reference"], "batchnorm_calls", None)
    if not tr or calls is None:
        return None
    device_s = sum(s for name, s in tr["device_s_by_name"].items()
                   if "dmt_bn" in name)
    if device_s <= 0:
        return None
    nbytes = sum(rows * c * (FWD_BYTES + BWD_BYTES)
                 for rows, c, _ in calls(ctx["config"]))
    return nbytes / costs.PEAK_HBM_BYTES * tr["steps"] / device_s * 100
