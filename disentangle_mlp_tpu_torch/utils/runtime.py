"""Process-level runtime of the port's CLIs (disentangle_mlp_tpu/utils/
runtime.py): the float32 precision policy and the ``--profile_dir`` trace.

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
"""

from __future__ import annotations

import os
from typing import Optional

_profiler = None
_profile_dir: Optional[str] = None


def float32_policy() -> None:
    """TF32 off for cuBLAS matmuls and cuDNN convolutions, process-wide."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup(profile_dir: str = "", device="cpu") -> None:
    """Start the trace into ``profile_dir`` (nothing when it is empty),
    with CUDA activities when ``device`` is a CUDA device."""
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
    prof.__exit__(None, None, None)
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}", flush=True)
    return path
