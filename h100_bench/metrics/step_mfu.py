"""step_mfu: the whole step's share of the card's bf16 peak, in %: the
FLOPs of the convolutions and dense layers that the step's passes need
(counted from the shapes by the reference's ``step_flops``, nothing
recomputed), times the window's steps, over the window's wall time times
989 TFLOP/s."""


def read(ctx):
    win, costs = ctx["window"], ctx["costs"]
    if not win["steps"] or win["wall_s"] <= 0:
        return None
    flops = ctx["reference"].step_flops(ctx["config"], costs)
    return flops * win["steps"] / win["wall_s"] / costs.PEAK_BF16_FLOPS * 100
