"""batchnorm_ms: the device's busy ms a traced step between the BatchNorms'
paired marks, forward and backward (``dmt.bn<k>#<call>.{fwd,bwd}``): what
the BatchNorms cost inside the graph's replays. Nothing is read when the
window's marks are not its replays times the mark table's length, or when
the graph was captured again in it."""

import program_trace


def read(ctx):
    return program_trace.mark_reading(ctx, "batchnorm_ms_per_step")
