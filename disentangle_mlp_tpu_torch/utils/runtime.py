"""Process-level runtime of the port's CLIs (disentangle_mlp_tpu/utils/
runtime.py): the float32 precision policy, the ``--profile_dir`` trace and
the port's spans and device marks.

``float32_policy()`` is the port's one precision policy: float32 means
float32 on the card. PyTorch lets cuDNN compute float32 convolutions in
TF32 (a 10-bit mantissa) unless told otherwise, and every float32
tolerance of the port, against the JAX package on the CPU and between the
card and the CPU, holds float32 computed as float32. So every entry point
turns TF32 off for cuBLAS matmuls and for cuDNN before it builds a model:
``train/loop.py::resolve_device`` calls it (the CLIs, the β search, the
reproduction and the trainer's runs resolve their device there), and so do
``parallel/mesh.py``'s spawned ranks. bf16 layers are untouched by it.

``setup(profile_dir, device)`` starts a ``torch.profiler`` trace of the
process (CPU activities, and CUDA ones when ``device`` is a GPU) and
``teardown``
stops it and writes it into ``profile_dir`` as a Chrome trace
(``trace_<pid>.json``, readable by Perfetto or chrome://tracing). An
empty ``profile_dir`` does nothing. The JAX package's other job here, the
XLA compilation cache, has no counterpart: the port's kernels are built
once into ``ops/_build.py``'s build directory.

**Spans and marks.** One switch, :func:`set_spans` (``setup`` turns it on
for its trace, ``teardown`` off again), and two tools that read it:

- ``span(name)``: a ``torch.profiler.record_function`` range while spans
  are on, so the range lands in whatever profiler runs (``--profile_dir``
  or a benchmark's); while they are off, one shared
  ``contextlib.nullcontext()``. The profiler lines host ranges up with the
  device's activity on one clock. It records the ranges of the thread that
  started it, not those of the loader's read thread or the cache warm-up.
- ``mark(tag, like)``: while spans are on, a one-thread kernel named
  ``dmt_trace_mark`` (``csrc/trace_mark.cu``) on the current stream of the
  CUDA tensor ``like``: a point on the device's timeline, for the work a
  CUDA graph replays, where no host range can reach. Under
  :func:`mark_table` (a capture on that stream) the tag is also appended to
  the capture's table, so the n-th mark of each replay is the table's n-th
  tag. A tag ends in ``.begin`` or ``.end``; one pair shares what comes
  before. Nothing happens on the CPU or while spans are off, so a graph
  captured with spans off holds no mark.

Every span and mark name starts with ``dmt.``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Dict, List, Optional

_profiler = None
_profile_dir: Optional[str] = None

_spans = False
_NULL_SPAN = contextlib.nullcontext()
# raw handle of a capturing stream -> the mark table of its capture
_tables: Dict[int, List[str]] = {}
_mark_launch = None


def float32_policy() -> None:
    """TF32 off for cuBLAS matmuls and cuDNN convolutions, process-wide."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_spans(on: bool) -> None:
    """Turn the port's spans and marks on or off, process-wide."""
    global _spans
    _spans = bool(on)


def spans_on() -> bool:
    return _spans


def span(name: str):
    """A profiler range named ``name`` while spans are on; the shared null
    context while they are off."""
    if not _spans:
        return _NULL_SPAN
    import torch

    return torch.profiler.record_function(name)


def _mark_fn():
    global _mark_launch
    if _mark_launch is None:
        from ..ops import _build

        fn = _build.load("trace_mark").dmt_trace_mark_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _mark_launch = fn
    return _mark_launch


def mark(tag: str, like) -> None:
    """Launch a ``dmt_trace_mark`` kernel on the current stream of
    ``like``'s device while spans are on and ``like`` is a CUDA tensor, and
    append ``tag`` to the table of a capture on that stream."""
    if not _spans or not like.is_cuda:
        return
    import torch

    stream = torch._C._cuda_getCurrentRawStream(like.device.index)
    err = _mark_fn()(stream)
    if err:
        raise RuntimeError(f"dmt_trace_mark launch failed: CUDA error {err}")
    table = _tables.get(stream)
    if table is not None:
        table.append(tag)


@contextlib.contextmanager
def mark_table(stream, table: List[str]):
    """Marks launched on ``stream`` (a ``torch.cuda.Stream``, from any
    thread: the backward runs on autograd's) append their tags to
    ``table`` inside the block."""
    key = stream.cuda_stream
    _tables[key] = table
    try:
        yield table
    finally:
        del _tables[key]


def setup(profile_dir: str = "", device="cpu") -> None:
    """Start the trace into ``profile_dir`` (nothing when it is empty),
    with CUDA activities when ``device`` is a CUDA device, and turn the
    port's spans on."""
    global _profiler, _profile_dir
    if not profile_dir:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _profiler is not None:
        raise RuntimeError(f"a trace into {_profile_dir!r} is already "
                           f"running")
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _profiler, _profile_dir = prof, profile_dir
    set_spans(True)


def teardown(profile_dir: str = "") -> Optional[str]:
    """Stop the trace started by :func:`setup` and write it; returns the
    trace file's path (None when nothing was traced)."""
    global _profiler, _profile_dir
    if not profile_dir:
        return None
    prof, out_dir = _profiler, _profile_dir
    _profiler = _profile_dir = None
    if prof is None:
        return None
    set_spans(False)
    prof.__exit__(None, None, None)
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}", flush=True)
    return path
