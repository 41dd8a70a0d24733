"""Reduction of the program's own spans and device marks in a
``torch.profiler`` trace of some training steps: what a ``--trace 1`` run
reads as ``tr["program"]`` once the harness passes it the profile (the
harness does not yet; PERF.md §7 names the two edits).

The program (``disentangle_mlp_tpu_torch/utils/runtime.py``, spans on)
leaves two things in a profile:

- host ranges named ``dmt.*`` on the thread that iterates the loader and
  steps (``dmt.feed``, ``dmt.feed.queue``, ``dmt.feed.sync``, ...), on the
  profiler's clock, which the device's activity shares;
- ``dmt_trace_mark`` kernels, which a CUDA graph's replay runs where its
  capture placed them: the n-th mark of a replay is the n-th tag of the
  capture's table (``MultiStep.marks``). A tag ends in ``.begin`` or
  ``.end``; ``dmt.step`` brackets each captured step, ``dmt.bn<k>#<call>.
  fwd`` and ``.bwd`` a BatchNorm's forward and backward.

From those, per traced step: the host ms of each span; the device's idle
gaps, each charged to the innermost span that covers more than half of it
(or else to the span covering most of it, or ``other``); the device's busy
ms between BatchNorms' paired marks, by the frozen kernel categories of
``tracing.py``; and the device's idle ms inside each replay's ``dmt.step``
marks. The mark readings are given only when the window's marks number its
replays times the table's length and no capture happened in it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import tracing

MARK_KERNEL = "dmt_trace_mark"
PREFIX = "dmt."
Event = Tuple[str, float, float]


def _overlap(a: float, b: float, s: float, e: float) -> float:
    return max(0.0, min(b, e) - max(a, s))


def _busy_within(busy: Sequence[Tuple[float, float]], a: float, b: float
                 ) -> float:
    return sum(_overlap(a, b, s, e) for s, e in busy)


def charge(gap: Tuple[float, float], spans: Sequence[Event]) -> str:
    """The span a device idle ``gap`` is charged to: the innermost (the
    shortest) of those covering more than half of it, else the one
    covering most of it, else ``other``."""
    a, b = gap
    covers = [(_overlap(a, b, s, e), e - s, n) for n, s, e in spans]
    covers = [c for c in covers if c[0] > 0]
    if not covers:
        return "other"
    most = [c for c in covers if c[0] > (b - a) / 2]
    if most:
        return min(most, key=lambda c: c[1])[2]
    return max(covers, key=lambda c: (c[0], -c[1]))[2]


def pairs(table: Sequence[str]) -> List[Tuple[str, int, int]]:
    """(name, index of its begin, index of its end) of each tag pair of a
    mark table, in the order of the begins."""
    open_at: Dict[str, int] = {}
    out = []
    for i, tag in enumerate(table):
        if tag.endswith(".begin"):
            open_at[tag[:-len(".begin")]] = i
        elif tag.endswith(".end"):
            name = tag[:-len(".end")]
            if name in open_at:
                out.append((name, open_at.pop(name), i))
    return sorted(out, key=lambda p: p[1])


def reduce_program(device_events: Sequence[Event],
                   host_spans: Sequence[Event], window: Tuple[float, float],
                   steps: int, table: Sequence[str], replays: int,
                   recaptured: bool) -> Dict:
    """``device_events``: (name, start us, end us) of every device activity
    (marks included); ``host_spans``: the program's ``dmt.*`` host ranges;
    ``window``: the traced window on the same clock; ``steps``: the steps in
    it; ``table``: the graph's mark table; ``replays``: the graph's replays
    in the window; ``recaptured``: whether a capture happened in it."""
    lo, hi = window
    spans = [(n, max(s, lo), min(e, hi)) for n, s, e in host_spans
             if n.startswith(PREFIX) and e > lo and s < hi]
    host_ms: Dict[str, float] = {}
    for n, s, e in spans:
        host_ms[n] = host_ms.get(n, 0.0) + (e - s) * 1e-3 / steps
    clipped = sorted((max(s, lo), min(e, hi), n) for n, s, e in device_events
                     if e > lo and s < hi)
    busy = tracing.union((s, e) for s, e, _ in clipped)
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle: Dict[str, float] = {}
    for g in gaps:
        n = charge(g, spans)
        idle[n] = idle.get(n, 0.0) + (g[1] - g[0]) * 1e-6
    out = {"steps": steps, "host_ms_per_step": host_ms,
           "idle_s_by_span": idle, "marks": 0, "table": len(table),
           "replays": replays, "recaptured": recaptured, "marks_ok": False}

    marks = [(s, e) for s, e, n in clipped if n == MARK_KERNEL]
    out["marks"] = len(marks)
    if recaptured or not table or len(marks) != replays * len(table):
        return out
    work = [(s, e, n) for s, e, n in clipped if n != MARK_KERNEL]
    work_busy = tracing.union((s, e) for s, e, _ in work)
    bn_intervals, step_gap_us = [], 0.0
    tag_pairs = pairs(table)
    for r in range(replays):
        at = marks[r * len(table):(r + 1) * len(table)]
        for name, i, j in tag_pairs:
            a, b = at[i][1], at[j][0]  # after the begin, before the end
            if name.startswith(PREFIX + "bn"):
                bn_intervals.append((a, b))
            elif name == PREFIX + "step":
                a, b = at[i][0], at[j][1]  # the marks are the step's
                step_gap_us += (b - a) - _busy_within(busy, a, b)
    bn = tracing.union(bn_intervals)
    by_cat: Dict[str, float] = {}
    for s, e, n in work:
        t = sum(_overlap(s, e, a, b) for a, b in bn)
        if t > 0:
            c = tracing.categorize(n)
            by_cat[c] = by_cat.get(c, 0.0) + t * 1e-3 / steps
    out.update(
        marks_ok=True,
        batchnorm_ms_per_step=sum(_busy_within(work_busy, a, b)
                                  for a, b in bn) * 1e-3 / steps,
        batchnorm_by_category_ms_per_step=by_cat,
        graph_gap_ms_per_step=step_gap_us * 1e-3 / steps)
    return out


def from_profiler(prof, steps: int, table: Sequence[str], replays: int,
                  recaptured: bool, window_span: str = "traced_window"
                  ) -> Dict:
    """:func:`reduce_program` of a finished ``torch.profiler.profile`` whose
    window is the host span ``window_span`` (as ``tracing.from_profiler``
    takes it)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        span = (e.name, float(tr.start), float(tr.end))
        annotation = getattr(e, "is_user_annotation", False) or \
            e.name == window_span
        if e.device_type == cuda:
            if not annotation:
                device.append(span)
        elif e.name == window_span:
            window = span[1:]
        elif e.name.startswith(PREFIX):
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    return reduce_program(device, host, window, steps, table, replays,
                          recaptured)


def breakdown(program: Dict, top: int = 10) -> List:
    """``idle_gaps_program``: the idle time by the program's innermost
    span, ``[name, seconds]``, longest first."""
    return [[k, v] for k, v in sorted(program["idle_s_by_span"].items(),
                                      key=lambda kv: -kv[1])][:top]


def mark_reading(ctx: Dict, key: str) -> Optional[float]:
    """``tr["program"][key]``, or None without the program's trace or when
    its marks do not add up."""
    tr = ctx.get("trace") or {}
    prog = tr.get("program")
    if not prog or not prog["marks_ok"]:
        return None
    return prog[key]


def span_ms(ctx: Dict, name: str) -> Optional[float]:
    """Host ms a traced step in the program's span ``name`` (None without
    the program's trace)."""
    tr = ctx.get("trace") or {}
    prog = tr.get("program")
    if not prog:
        return None
    return prog["host_ms_per_step"].get(name, 0.0)
