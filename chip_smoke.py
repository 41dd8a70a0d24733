#!/usr/bin/env python3
"""Smoke run of the PyTorch port (disentangle_mlp_tpu_torch) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name, nvidia-smi name and power limit; TF32 off for matmuls
   and cuDNN;
2. build every CUDA kernel of the training path from ``csrc/`` (one nvcc per
   source, started together) and hold each against its plain PyTorch version
   on the card, forward and gradient, at the shapes the full-width training
   step gives it and at an odd shape with no tile multiples;
3. time each kernel at those shapes beside its bound, its plain version and
   one PyTorch library call computing the same function;
4. train: the port's trainer CLI at full default width (batch 256, 64×64×3,
   n_hidden 128, bf16), synthetic data, 4 steps in freeze mode 'observed'
   and 2 in 'intent', with every loss finite and the kernel launch counts
   equal to launches per step × steps;
5. print the ``kernels`` JSON line, the card line and, last, the ok line.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, ".verify_runs", "chip_smoke")
BATCH = 256

# Peak rates of an H100 SXM (NVIDIA data sheet, dense): bytes/s of HBM3 and
# bf16 tensor-core FLOP/s. bound = max(bytes / BW, flops / PEAK).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# fused_linear calls of one full-width β-VAE-GAN step (train/vaegan.py):
# (role, M, K, N, activation, x dtype name, calls per step). K=16384 is the
# flattened 8·8·256 conv map, N=2048 the head / Dis_l width.
FUSED_LINEAR_SHAPES = [
    ("mu_fc1/lv_fc1", BATCH, 16384, 2048, "none", "bfloat16", 4),
    ("lth_features", BATCH, 16384, 2048, "leaky_relu", "bfloat16", 5),
    ("preprocess", BATCH, 128, 16384, "none", "bfloat16", 3),
    ("mu_fc2/lv_fc2", BATCH, 2048, 128, "none", "bfloat16", 4),
    ("sigmoid_output", BATCH, 2048, 1, "none", "float32", 5),
]
LAUNCHES_PER_STEP = sum(s[-1] for s in FUSED_LINEAR_SHAPES)

# Tolerances, as a share of the plain output's largest magnitude. Both sides
# multiply the same bf16-rounded operands in float32; only the summation
# order differs, so a float32 output agrees to ~K·2⁻²⁴ and a bf16 output to
# one bf16 rounding (2⁻⁸). The backward runs bf16 GEMMs (kernel path) against
# float32 products rounded to bf16 (plain path): two bf16 roundings.
TOL_FWD = {"float32": 1e-4, "bfloat16": 8e-3}
TOL_GRAD = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / scale if scale > 0 else d


def check_fused_linear(fl, torch) -> dict:
    """Forward and gradient of the kernel against fused_linear_plain;
    returns the largest errors seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0, "grad_rel_err": 0.0}

    def inputs(m, k, n, xdt):
        x = torch.randn(m, k, device=dev, generator=gen).to(xdt)
        w = torch.randn(n, k, device=dev, generator=gen) * k ** -0.5
        b = torch.randn(n, device=dev, generator=gen) * 0.1
        return x, w, b

    def fwd(label, x, w_kn, b, act, out):
        got = fl.fused_linear(x, w_kn, b, act, out)
        want = fl.fused_linear_plain(x, w_kn, b, act, out)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"fused_linear {label}: {got.dtype}{tuple(got.shape)} vs "
                 f"{want.dtype}{tuple(want.shape)}")
        if not torch.isfinite(got.float()).all():
            fail(f"fused_linear {label}: non-finite output")
        a, r = rel_err(got, want)
        tol = TOL_FWD[str(out).replace("torch.", "")]
        say(f"[check] fused_linear {label} act={act} out={out}: max abs err "
            f"{a:.3e}, rel {r:.3e} (tol {tol:.0e})")
        if r > tol:
            fail(f"fused_linear {label} act={act} out={out}: rel err {r:.3e} "
                 f"> {tol:.0e}")
        worst["max_abs_err"] = max(worst["max_abs_err"], a)
        worst["max_rel_err"] = max(worst["max_rel_err"], r)

    def grad(label, x, w, b, act, out):
        """Gradients of the kernel's autograd Function against autograd of
        the plain version. act' is a step at 0, and where the pre-activation
        lies within rounding of 0 the two forwards may pick opposite sides;
        so the reference is the plain version without activation, fed
        dY ⊙ act'(y) with act' read from the kernel's output y."""
        dy = torch.randn(x.shape[0], w.shape[0], device=dev,
                         generator=gen).to(out).float()
        res = []
        xs, ws, bs = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, b))
        y = fl.fused_linear(xs, ws.t(), bs, act, out)
        (y.float() * dy).sum().backward()
        res.append((xs.grad, ws.grad, bs.grad))
        y = y.detach()
        slope = {"none": torch.ones_like(y, dtype=torch.float32),
                 "relu": (y > 0).float(),
                 "leaky_relu": torch.where(y >= 0, 1.0, 0.2)}[act]
        flips = int(((y > 0) != (fl.fused_linear_plain(x, w.t(), b, act, out)
                                 > 0)).sum()) if act != "none" else 0
        xs, ws, bs = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, b))
        y = fl.fused_linear_plain(xs, ws.t(), bs, "none", out)
        (y.float() * dy * slope).sum().backward()
        res.append((xs.grad, ws.grad, bs.grad))
        torch.cuda.synchronize()
        if flips:
            say(f"[check] fused_linear {label} act={act}: {flips} outputs "
                f"change sign between kernel and plain forward")
        for name, got, want in zip(("dx", "dw", "db"), *res):
            if not torch.isfinite(got.float()).all():
                fail(f"fused_linear {label} {name}: non-finite gradient")
            _, r = rel_err(got, want)
            say(f"[check] fused_linear {label} act={act} {name}: rel err "
                f"{r:.3e} (tol {TOL_GRAD:.0e})")
            if r > TOL_GRAD:
                fail(f"fused_linear {label} {name}: rel err {r:.3e} > "
                     f"{TOL_GRAD:.0e}")
            worst["grad_rel_err"] = max(worst["grad_rel_err"], r)

    # the odd shape: M, K and N not tile multiples; every activation, both
    # output types, both weight layouts
    x, w, b = inputs(100, 300, 70, torch.float32)
    for act in ("none", "relu", "leaky_relu"):
        for out in (torch.float32, torch.bfloat16):
            fwd("odd 100x300x70 (N,K) weight", x, w.t(), b, act, out)
            fwd("odd 100x300x70 (K,N) weight", x, w.t().contiguous(), b,
                act, out)
        grad("odd 100x300x70", x, w, b, act, torch.float32)
    # the training step's shapes, as the step calls them: a float32 (N, K)
    # weight read through its transpose, bf16 output
    for role, m, k, n, act, xdt, _ in FUSED_LINEAR_SHAPES:
        x, w, b = inputs(m, k, n, getattr(torch, xdt))
        label = f"{role} {m}x{k}x{n}"
        for out in (torch.bfloat16, torch.float32):
            fwd(label, x, w.t(), b, act, out)
        grad(label, x, w, b, act, torch.bfloat16)
        del x, w, b
    return worst


def time_fused_linear(fl, torch) -> list:
    """kernel, plain and library (torch.addmm on bf16 copies, then the
    activation) times at each main-path shape, with the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for role, m, k, n, act, xdt, per_step in FUSED_LINEAR_SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen).to(getattr(torch,
                                                                   xdt))
        w = torch.randn(n, k, device=dev, generator=gen) * k ** -0.5
        b = torch.randn(n, device=dev, generator=gen) * 0.1
        w_kn, out = w.t(), torch.bfloat16
        x16, w16, b16 = x.bfloat16(), w_kn.bfloat16(), b.bfloat16()

        def library():
            y = torch.addmm(b16, x16, w16)
            if act == "leaky_relu":
                y = torch.nn.functional.leaky_relu(y, 0.2)
            return y

        kernel_ms = time_ms(lambda: fl.fused_linear(x, w_kn, b, act, out))
        plain_ms = time_ms(lambda: fl.fused_linear_plain(x, w_kn, b, act,
                                                         out))
        library_ms = time_ms(library)
        nbytes = (x.numel() * x.element_size() + w.numel() * 4
                  + b.numel() * 4 + m * n * 2)
        flops = 2 * m * n * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        rows.append({
            "role": role, "M": m, "K": k, "N": n, "activation": act,
            "x_dtype": xdt, "w_dtype": "float32", "out_dtype": "bfloat16",
            "launches_per_step": per_step, "bytes": nbytes, "flops": flops,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        say(f"[time] fused_linear {role} {m}x{k}x{n}: kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
            f"({rows[-1]['bound_by']})")
        del x, w, b, x16, w16, b16
    return rows


def train(fl, mode: str, size: int, card: str) -> int:
    """Full-width training through the trainer CLI; returns the kernel
    launches it made."""
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    import torch

    steps = size // BATCH
    argv = ["--model", "betavaegan", "--name", f"smoke_{mode}",
            "--device", "cuda", "--epochs", "1",
            "--batch_size_train", str(BATCH), "--dtype", "bfloat16",
            "--synthetic_data", "True", "--synthetic_train_size", str(size),
            "--calc_fid", "False", "--checkpoint_every", "0",
            "--freeze_mode", mode,
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    fl.launches = 0
    t0 = time.perf_counter()
    out = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.launches
    metrics = out["step_metrics"]
    values = [out["Avg Eec Loss"], out["Avg Dis Loss"], *metrics.values()]
    if not all(math.isfinite(v) for v in values):
        fail(f"train {mode}: non-finite loss {out}")
    if launches != LAUNCHES_PER_STEP * steps:
        fail(f"train {mode}: fused_linear launched {launches} times, "
             f"expected {LAUNCHES_PER_STEP} x {steps} steps")
    rate = out["images_per_sec"]
    say(f"[train] {mode}: {steps} steps at batch {BATCH}, bf16, full "
        f"width; {rate:.1f} img/s, {BATCH / rate * 1e3:.2f} ms/step "
        f"(steps 2..{steps}); wall {wall:.1f} s incl. init; fused_linear "
        f"launches {launches} = {LAUNCHES_PER_STEP} x {steps}; last step "
        f"{json.dumps(metrics)}; card {card}")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        from disentangle_mlp_tpu_torch.ops import _build
        from disentangle_mlp_tpu_torch.ops import fused_linear as fl
    except ImportError as e:
        fail(f"the port's package is not importable from {REPO}: {e}")

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; TF32 off")

    # 2. build and check
    t0 = time.perf_counter()
    libs = _build.build_all(["fused_linear"])
    say(f"[build] {', '.join(str(p.name) for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    worst = check_fused_linear(fl, torch)

    # 3. time
    rows = time_fused_linear(fl, torch)

    # 4. train
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        launches = (train(fl, "observed", 4 * BATCH, card)
                    + train(fl, "intent", 2 * BATCH, card))
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)

    # 5. report
    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    t_bytes = sum(r["bytes"] * r["launches_per_step"]
                  for r in rows) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] * r["launches_per_step"]
                for r in rows) / BF16_FLOPS_PER_S
    kernels = [{
        "name": "fused_linear", "route": "cuda",
        "source": "disentangle_mlp_tpu_torch/csrc/fused_linear.cu",
        "replaces": "disentangle_mlp_tpu/ops/pallas/matmul_fused.py:71",
        "launches": launches, "max_abs_err": worst["max_abs_err"],
        "max_rel_err": worst["max_rel_err"],
        "grad_rel_err": worst["grad_rel_err"],
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_step("library_ms"),
        "times_are": f"sums over the {LAUNCHES_PER_STEP} launches of one "
                     f"training step",
        "shapes": rows,
    }]
    say(json.dumps({"kernels": kernels}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
