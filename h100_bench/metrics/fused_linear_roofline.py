"""fused_linear_roofline: the dense kernel's share of its roofline, in %:
the sum over the traced steps' launches of max(bytes / 3.35 TB/s, FLOPs /
989 TFLOP/s), each launch's shapes from the reference's
``fused_linear_launches``, over the device time of the kernels named
``fused_linear_*`` in those steps. Nothing is read when the kernel's
launch counter disagrees with the shapes' count (a launch taken off or
added), or when no such kernel ran."""


def read(ctx):
    tr, costs = ctx.get("trace"), ctx["costs"]
    if not tr:
        return None
    launches = ctx["reference"].fused_linear_launches(ctx["config"])
    device_s = tr["by_category_ms_per_step"].get("fused_linear", 0.0) \
        * tr["steps"] * 1e-3
    if device_s <= 0 or tr["fused_linear_launches"] != \
            len(launches) * tr["steps"]:
        return None
    bound = sum(costs.fused_linear_bound_seconds(*l) for l in launches)
    return bound * tr["steps"] / device_s * 100
