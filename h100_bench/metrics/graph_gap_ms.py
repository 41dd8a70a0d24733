"""graph_gap_ms: the device's idle ms a traced step inside the graph's
replays: each replay's ``dmt.step`` marks' interval less the device's busy
time within it (the gaps between a replay's kernels, not the host's late
launches between replays). Nothing is read when the window's marks are
not its replays times the mark table's length, or when the graph was
captured again in it."""

import program_trace


def read(ctx):
    return program_trace.mark_reading(ctx, "graph_gap_ms_per_step")
