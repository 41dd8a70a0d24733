"""Reduction of a ``torch.profiler`` trace of some training steps to the
numbers the per-layer metrics read.

``CATEGORIES`` and :func:`categorize` are a frozen copy of
``disentangle_mlp_tpu_torch/cli/profile_step.py`` (kernel categories by
name), as is the busy and idle arithmetic: busy is the device's time
running something, idle is ``1 - busy / wall``. Here busy is the union of
the device's activity intervals, so two kernels that overlap count once,
and the wall is the traced window's host clock between two synchronises.

Host spans are the benchmark's own ``record_function`` ranges around the
calls it makes into the program (``feed``, ``step``, ``draw``,
``epoch_end``); a device idle gap is charged to the span that covers most
of it, or to ``other``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# -- frozen copy of cli/profile_step.py ------------------------------------
# (category, substrings of a lower-cased kernel name); first match wins.
# cuDNN's implicit-GEMM convolutions carry "gemm" in their names too, so
# the convolution patterns come before the matmul ones. Every device kernel
# of csrc/fused_linear.cu is named fused_linear_*: the stream path and its
# split-K reducer, the dot path, the generic path.
CATEGORIES = (
    ("fused_linear", ("fused_linear_",)),
    ("convolution", ("conv", "cudnn", "dgrad", "wgrad", "fprop")),
    ("matmul", ("gemm", "nvjet", "cublas")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("memcpy/memset", ("memcpy", "memset")),
)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"
# -- end of the frozen copy --------------------------------------------------

HOST_SPANS = ("feed", "step", "draw", "epoch_end")
Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(device_events: Sequence[Tuple[str, float, float]],
                 host_spans: Sequence[Tuple[str, float, float]],
                 window: Interval, steps: int) -> Dict:
    """``device_events``: (kernel name, start us, end us) of every device
    activity; ``host_spans``: (span name, start us, end us); ``window``:
    the traced window's (start us, end us) on the same clock; ``steps``:
    the steps in it. Returns seconds and per-step milliseconds."""
    lo, hi = window
    clipped = [(n, max(a, lo), min(b, hi)) for n, a, b in device_events
               if b > lo and a < hi]
    busy = union((a, b) for _, a, b in clipped)
    busy_us = sum(b - a for a, b in busy)
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for n, a, b in clipped:
        by_cat[categorize(n)] = by_cat.get(categorize(n), 0.0) + (b - a)
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle_by_span: Dict[str, float] = {}
    for a, b in gaps:
        best, cover = "other", 0.0
        for n, s, e in host_spans:
            c = min(b, e) - max(a, s)
            if c > cover:
                best, cover = n, c
        idle_by_span[best] = idle_by_span.get(best, 0.0) + (b - a)
    window_us = hi - lo
    return {
        "steps": steps,
        "window_s": window_us * 1e-6,
        "busy_s": busy_us * 1e-6,
        "idle_share": 1.0 - busy_us / window_us if window_us > 0 else None,
        "by_category_ms_per_step": {k: v * 1e-3 / steps
                                    for k, v in by_cat.items()},
        "device_s_by_name": {k: v * 1e-6 for k, v in by_name.items()},
        "idle_s_by_span": {k: v * 1e-6 for k, v in idle_by_span.items()},
        "kernels": len(clipped),
    }


def from_profiler(prof, steps: int, window_span: str = "traced_window"
                  ) -> Dict:
    """:func:`reduce_trace` of a finished ``torch.profiler.profile`` whose
    window is the host span ``window_span`` (it ends after a
    synchronise). Device activity is every CUDA event but the user
    annotations that ``record_function`` ranges leave there."""
    import torch

    device, host, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        span = (e.name, float(tr.start), float(tr.end))
        if getattr(e, "is_user_annotation", False) or \
                e.name in HOST_SPANS + (window_span,):
            # a record_function range shows on the device's timeline too,
            # as an annotation over everything it covers: no activity
            if e.device_type != torch.autograd.DeviceType.CUDA:
                if e.name == window_span:
                    window = span[1:]
                elif e.name in HOST_SPANS:
                    host.append(span)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    return reduce_trace(device, host, window, steps)


def breakdown(trace: Dict, top: int = 10, width: int = 120) -> Dict:
    """The device operations that took most time and the idle time by
    what the host was doing, ``[name, seconds]`` each, longest first
    (names cut to ``width`` characters)."""
    def ranked(d):
        return [[k[:width], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])][:top]

    return {"device_ops": ranked(trace["device_s_by_name"]),
            "idle_gaps": ranked(trace["idle_s_by_span"])}
