"""Step-time breakdown of one of the port's training steps on a GPU:

    python -m disentangle_mlp_tpu_torch.cli.profile_step --name prof \
        [--model vae|gan|betavaegan] [--freeze_mode observed|intent] \
        [--dataset birds --img_size 128 | --dataset mnist --img_size 28 \
         --input_channels 1] [trainer flags ...]

Builds the experiment at the configured width (full default width unless
flags shrink it; ``--dataset birds|mnist`` builds that family's experiment
whatever ``--model`` says, as the trainer does), trains WARMUP steps on one
synthetic batch, then times
STEPS steps with CUDA events (ms/step) and profiles as many more with
``torch.profiler``. Prints one JSON object: ms/step, device busy time,
idle share and kernel count per step, device time per kernel category and
the top kernels by device time, fused_linear launches per step (in all and
by path), peak device memory, and the card. A CUDA device is required:
there is no CPU measurement.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import torch

from ..config import Config, build_arg_parser
from ..data.pipeline import SyntheticSource
from ..ops import fused_linear as fl
from ..train.families import FAMILY_DATASETS, FamilyExperiment
from ..train.gan import GANExperiment
from ..train.vae import VAEExperiment
from ..train.vaegan import VAEGANExperiment

EXPERIMENTS = {"vae": VAEExperiment, "gan": GANExperiment,
               "betavaegan": VAEGANExperiment}

WARMUP, STEPS, TOP = 5, 20, 12
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


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("profiler events carry no device time")


def kernel_breakdown(events, steps: int, top: int) -> Dict:
    """Device time per step (ms) by category and the top kernels, from
    ``prof.key_averages()`` over ``steps`` steps."""
    kernels: List = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: Dict[str, float] = {}
    for e in kernels:
        cat = categorize(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + _device_us(e) / 1e3 / steps
    ranked = sorted(kernels, key=_device_us, reverse=True)[:top]
    return {
        "busy_ms": sum(by_cat.values()),
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "by_category_ms": dict(sorted(by_cat.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:120], "category": categorize(e.key),
                         "ms_per_step": _device_us(e) / 1e3 / steps,
                         "calls_per_step": e.count / steps}
                        for e in ranked],
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = build_arg_parser("disentangle_mlp_tpu_torch step profile")
    parser.add_argument("--model", type=str, default="betavaegan",
                        choices=sorted(EXPERIMENTS))
    ns = parser.parse_args(argv)
    model = ns.model
    cfg = Config(**{k: v for k, v in vars(ns).items() if k != "model"}
                 ).finalize(make_dirs=False)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures a CUDA device and found "
                           "none")
    device = torch.device("cuda")
    if cfg.dataset in FAMILY_DATASETS:
        model = cfg.dataset
        exp = FamilyExperiment(cfg, device)
    else:
        exp = EXPERIMENTS[model](cfg, device)
    src = SyntheticSource(size=cfg.batch_size_train, img_size=cfg.img_size,
                          channels=cfg.input_channels, seed=cfg.seed)
    x, _ = src.load_batch(range(cfg.batch_size_train))
    x = torch.from_numpy(x).to(device)

    for _ in range(WARMUP):
        exp.train_step(x)
    torch.cuda.synchronize()
    fl.launches = 0
    fl.path_launches.clear()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(STEPS):
        exp.train_step(x)
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / STEPS
    launches = fl.launches / STEPS
    by_path = {p: c / STEPS for p, c in sorted(fl.path_launches.items())}

    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            exp.train_step(x)
        torch.cuda.synchronize()
    brk = kernel_breakdown(prof.key_averages(), STEPS, TOP)
    if brk["busy_ms"] <= 0:
        raise RuntimeError("the profiler recorded no device time")
    out = {
        "device": torch.cuda.get_device_name(0), "model": model,
        "freeze_mode": cfg.freeze_mode, "dtype": cfg.dtype,
        "batch": cfg.batch_size_train, "steps": STEPS,
        "ms_per_step": ms_per_step,
        "images_per_sec": cfg.batch_size_train / ms_per_step * 1e3,
        "device_busy_ms_per_step": brk["busy_ms"],
        "device_idle_share": max(0.0, 1.0 - brk["busy_ms"] / ms_per_step),
        "device_kernels_per_step": brk["kernels_per_step"],
        "fused_linear_launches_per_step": launches,
        "fused_linear_launches_per_step_by_path": by_path,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "by_category_ms_per_step": brk["by_category_ms"],
        "top_kernels": brk["top_kernels"],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
