"""Step-time breakdown of the port's training steps on a GPU:

    python -m disentangle_mlp_tpu_torch.cli.profile_step --name prof \
        [--model vae|gan|betavaegan|all] [--freeze_mode observed|intent] \
        [--dataset birds --img_size 128 | --dataset mnist --img_size 28 \
         --input_channels 1] [trainer flags ...]

Builds the experiment at the configured width (full default width unless
flags shrink it; ``--dataset birds|mnist`` builds that family's experiment
whatever ``--model`` says, as the trainer does) and measures its step
three ways on one synthetic batch, one after another on the same
experiment:

- ``eager``: ``train_step`` called from Python, as on the CPU;
- ``graph``: the trainer's way on the card, one replay of a one-step CUDA
  graph a step (train/scan.py, draws and batch copied in);
- ``multi_step_8``: ``make_multi_step`` with K = 8, one replay a call.

Each is warmed up, then STEPS steps are timed with CUDA events (ms/step)
and PROFILED more are profiled with ``torch.profiler`` (the kernels inside
a graph's replay included). Prints one JSON object: the eager step's
ms/step, device busy time, idle share and kernels per step, device time by
kernel category and the top kernels, fused_linear launches per step (in
all and by path; a replay counts the launches its capture recorded), peak
device memory and the card; under ``variants`` the same for each of the
three ways. ``--model all`` measures the six step kinds in one run (the
β-VAE-GAN in both freeze modes, the VAE, the DCGAN, the birds family at
128×128 and the MNIST family at 28×28×1) and prints one such line each. A
CUDA device is required: there is no CPU measurement.
"""

from __future__ import annotations

import gc
import json
from typing import Dict, List, Optional

import torch

from ..config import Config, build_arg_parser
from ..data.pipeline import SyntheticSource
from ..ops import fused_linear as fl
from ..train.families import FAMILY_DATASETS, FamilyExperiment
from ..train.gan import GANExperiment
from ..train.loop import resolve_device
from ..train.scan import make_multi_step
from ..train.vae import VAEExperiment
from ..train.vaegan import VAEGANExperiment

EXPERIMENTS = {"vae": VAEExperiment, "gan": GANExperiment,
               "betavaegan": VAEGANExperiment}

# The six step kinds of --model all: (label, model, config overrides).
KINDS = (
    ("betavaegan observed", "betavaegan", {"freeze_mode": "observed"}),
    ("betavaegan intent", "betavaegan", {"freeze_mode": "intent"}),
    ("vae", "vae", {}),
    ("gan", "gan", {}),
    ("birds", "birds", {"dataset": "birds", "img_size": 128}),
    ("mnist", "mnist", {"dataset": "mnist", "img_size": 28,
                        "input_channels": 1}),
)
MULTI_K = 8
VARIANTS = ("eager", "graph", f"multi_step_{MULTI_K}")
WARMUP, STEPS, PROFILED, TOP = 8, 24, 8, 12
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


def _runner(exp, x: torch.Tensor, variant: str):
    """(a call running some steps of ``exp`` on ``x``, steps per call)."""
    if variant == "eager":
        return (lambda: exp.train_step(x)), 1
    k = 1 if variant == "graph" else MULTI_K
    multi = make_multi_step(exp, k)
    xs = x.expand((k,) + tuple(x.shape))
    multi.capture(xs)
    return (lambda: multi(xs)), k


def measure(exp, x: torch.Tensor, variant: str) -> Dict:
    """One way of stepping ``exp``: ms/step over STEPS steps by CUDA
    events, then device time by kernel from PROFILED profiled steps."""
    run, per_call = _runner(exp, x, variant)
    for _ in range(-(-WARMUP // per_call)):
        run()
    torch.cuda.synchronize()
    fl.launches = 0
    fl.path_launches.clear()
    calls = STEPS // per_call
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    steps = calls * per_call
    ms_per_step = start.elapsed_time(end) / steps
    out = {"ms_per_step": ms_per_step,
           "images_per_sec": x.shape[0] / ms_per_step * 1e3,
           "fused_linear_launches_per_step": fl.launches / steps,
           "fused_linear_launches_per_step_by_path": {
               p: c / steps for p, c in sorted(fl.path_launches.items())}}
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = -(-PROFILED // per_call)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    brk = kernel_breakdown(prof.key_averages(), calls * per_call, TOP)
    if brk["busy_ms"] <= 0:
        raise RuntimeError(f"the profiler recorded no device time ({variant})")
    out.update({
        "device_busy_ms_per_step": brk["busy_ms"],
        "device_idle_share": max(0.0, 1.0 - brk["busy_ms"] / ms_per_step),
        "device_kernels_per_step": brk["kernels_per_step"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "by_category_ms_per_step": brk["by_category_ms"],
        "top_kernels": brk["top_kernels"]})
    return out


def profile(cfg: Config, model: str, kind: Optional[str] = None) -> Dict:
    """The three ways of stepping one experiment; see the module
    docstring."""
    device = resolve_device("cuda")  # and the float32 policy
    if cfg.dataset in FAMILY_DATASETS:
        model = cfg.dataset
        exp = FamilyExperiment(cfg, device)
    else:
        exp = EXPERIMENTS[model](cfg, device)
    src = SyntheticSource(size=cfg.batch_size_train, img_size=cfg.img_size,
                          channels=cfg.input_channels, seed=cfg.seed)
    x, _ = src.load_batch(range(cfg.batch_size_train))
    x = torch.from_numpy(x).to(device)
    variants = {v: measure(exp, x, v) for v in VARIANTS}
    out = {"device": torch.cuda.get_device_name(0), "kind": kind or model,
           "model": model, "freeze_mode": cfg.freeze_mode,
           "dtype": cfg.dtype, "batch": cfg.batch_size_train,
           "steps": STEPS, **variants["eager"],
           "variants": {k: {m: v[m] for m in v if m != "top_kernels"}
                        for k, v in variants.items()}}
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[List[str]] = None):
    """One experiment's profile (a dict), or with ``--model all`` the six
    step kinds' (a list)."""
    parser = build_arg_parser("disentangle_mlp_tpu_torch step profile")
    parser.add_argument("--model", type=str, default="betavaegan",
                        choices=sorted(EXPERIMENTS) + ["all"])
    ns = parser.parse_args(argv)
    kwargs = {k: v for k, v in vars(ns).items() if k != "model"}
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures a CUDA device and found "
                           "none")
    if ns.model != "all":
        return profile(Config(**kwargs).finalize(make_dirs=False), ns.model)
    outs = []
    for label, model, overrides in KINDS:
        cfg = Config(**{**kwargs, **overrides}).finalize(make_dirs=False)
        outs.append(profile(cfg, model, label))
        gc.collect()
        torch.cuda.empty_cache()
    return outs


if __name__ == "__main__":
    main()
