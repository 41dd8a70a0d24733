"""depthwise_roofline: the depthwise convolution kernels' share of their
byte roofline, in %: the bytes the step's depthwise convolutions have to
move (each convolution of the reference's ``layers`` with ``groups`` > 1,
stride 1, batch × pixels × C elements: x in and y out forward, x and dy in
and dx out backward, 4 and 6 B an element in bf16) at 3.35 TB/s, times the
traced steps, over the device time of the kernels whose names carry
``dmt_dwconv`` (``csrc/depthwise_conv.cu``) in those steps. Nothing is read
for a reference without ``layers`` or without such a convolution, or when
no such kernel ran."""

FWD_BYTES, BWD_BYTES = 4, 6


def step_bytes(layers, batch: int) -> int:
    """The bytes a step's depthwise convolutions move, at least."""
    return sum(batch * l["hw_in"] ** 2 * l["groups"] * (FWD_BYTES + BWD_BYTES)
               for l in layers
               if l.get("kind") == "conv" and l.get("groups", 1) > 1)


def read(ctx):
    tr, costs = ctx.get("trace"), ctx["costs"]
    layers = getattr(ctx["reference"], "layers", None)
    if not tr or layers is None:
        return None
    nbytes = step_bytes(layers(ctx["config"]),
                        ctx["config"]["batch_size_train"])
    device_s = sum(s for name, s in tr["device_s_by_name"].items()
                   if "dmt_dwconv" in name)
    if nbytes <= 0 or device_s <= 0:
        return None
    return nbytes / costs.PEAK_HBM_BYTES * tr["steps"] / device_s * 100
