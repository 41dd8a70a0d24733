#!/usr/bin/env python3
"""Smoke run of the PyTorch port (disentangle_mlp_tpu_torch) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name, nvidia-smi name and power limit; the device resolved
   as every entry point of the port resolves it
   (``train/loop.py::resolve_device``, which sets the port's float32
   policy), and the TF32 switches for matmuls and cuDNN as it left them:
   off (this script sets neither; the run fails if either is on, here and
   after the phases that run the port's entry points in this process);
2. build every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
   started together; ptxas's registers and spills per kernel) and hold each
   against its plain PyTorch version on the card: ``fused_linear`` forward
   (with the path and split count its plan chose, and two launches
   bit-identical) and gradient at the shapes the full-width training step
   gives it, forward at the FID decode's and at shapes on each path's
   edges, and at an odd shape with no tile multiples;
   ``per_image_normalize`` at the CelebA FID path's (1000, 64, 64, 3) and
   the birds FID path's (1000, 128, 128, 3) in the decoder's layout and
   contiguous, at an odd shape, on a constant image and on an image holding
   a NaN; the BatchNorm passes (``[check] batchnorm``) at every BatchNorm
   shape of the full-width β-VAE-GAN step, channels-last as the step
   gives them, forward and backward with the module's activation, and at
   every BatchNorm shape and activation of NVAE's step (the plain
   reference's table, h100_bench/reference/nvae.py ``batchnorm_calls``),
   against their plain passes (tests/test_torch_port_batchnorm.py's
   tolerances) and two launches bit-identical; ``[check] fused_linear``
   also at NVAE's squeeze-excitation shapes (the reference's
   ``fused_linear_launches``, ReLU after the first layer); the depthwise
   convolution (``[check] depthwise_conv``) at NVAE's seven shapes (the
   reference's layer table, batch 128, channels-last): y, dx and dw of the
   float32 kernels against the plain version in float32, of the bf16
   kernels against the plain version in bf16 and against ``F.conv2d``
   (cuDNN), each within ``TOL_DW``, and two launches bit-identical, dw
   included;
3. time each kernel at its main-path shapes beside its bound, its plain
   version and, where one exists, one PyTorch library call computing the
   same function (for ``fused_linear`` two: ``torch.addmm`` on bf16 copies
   made beforehand, and with the casts from the port's float32 weight);
   ``per_image_normalize`` at both FID shapes, with its device-only time;
   the BatchNorm passes (``[time] batchnorm``) at each step shape, forward
   and backward, against the bytes the function has to move at 3.35 TB/s
   (and the two-pass design's own), the library's ``F.batch_norm`` with
   the activation in place and the ATen chain they replace, and summed
   over one step's 42 forward and 38 backward calls; the kernels alone at
   each of NVAE's 18 BatchNorm shapes (``[time] batchnorm nvae``), summed
   over its step's 436 calls each way; the depthwise kernels at NVAE's
   seven shapes (``[time] depthwise_conv nvae``), forward and backward,
   device-only, against the bytes the function has to move, ``F.conv2d``
   (``library``) and the plain version, the backward's fused pass and
   finalize apart from the profiler, and summed over the step's 72 calls
   each way (``per nvae step``) beside the 17.4 ms bound;
   then train/scan.py's CUDA graphs (``[scan]``): for each of the six step
   kinds at full default width (the β-VAE-GAN in both freeze modes, the
   VAE, the DCGAN, the birds and MNIST families), from one copied state,
   4 eager steps twice (the card's run-to-run spread) and one replay of
   ``make_multi_step`` with K = 4 on the same batches and draws: every
   metric, parameter, running statistic, Adam moment and count of the
   graphed run within the eager runs' largest |Δ| of that tensor (or
   bit-identical where they are), fused_linear launches 4 × 21, 4 × 21,
   4 × 5, 4 × 7, 0, 0, and the BatchNorms' 4 × 80, 4 × 75, 4 × 18, 4 × 32,
   0, 0;
4. FID set-up: reference statistics of 2048 synthetic images through the
   port's ``compute_dataset_statistics``; those images scored against their
   own statistics (|FID| ≈ 0); pool3 on the card against pool3 on the CPU;
5. train: the port's trainer CLI at full default width (batch 256, 64×64×3,
   n_hidden 128, bf16), synthetic data: the β-VAE-GAN 4 steps in freeze
   mode 'observed' with FID over 1000 decoded samples (and their PNG
   files), then 2 steps in 'intent' without FID, saving its checkpoint
   (the JAX package's format; the save timed); the plain VAE 2 steps
   without FID; the DCGAN 3 steps with FID over 1000 generated samples;
   first of all, while the card's memory is free, NVAE at its published
   widths and batch 128 (``--model nvae``, h100_bench/configs/
   nvae_celeba64.json) 3 steps without FID, its launches a step those of
   the reference's tables: a BatchNorm call each way for each of its
   BatchNorms, the Swish ones counted apart, two ``fused_linear`` calls
   for each cell's squeeze-excitation, and a depthwise call each way for
   each of its 72 depthwise 5×5 (``NVAE_DW_LAUNCHES``; every other run
   makes none); its peak reserved memory no more than the 79.83 GB it
   reserved through cuDNN.
   Every loss and FID finite, and each kernel's launch count, set to 0 just
   before each run and read just after, equal to what the run's code path
   launches (fused_linear's also by path; the BatchNorms' a step and a
   FID's, ``BN_STEP_LAUNCHES``, and the Swish calls among them,
   ``BN_SWISH_LAUNCHES``; every BatchNorm call through the ring, and
   NVAE's copies before them ``NVAE_BN_COPIES`` a step). The trainer runs
   its first step
   eagerly and every later one as a replay of the step's CUDA graph, whose
   capture's launches each replay adds to the counts, and writes its
   checkpoints with the AsyncCheckpointer (how long ``save()`` blocked and
   when the file landed);
6. eval: the evaluation CLI sweeps the 'intent' checkpoint (FID,
   reconstruction, originals and sample grids), its launches checked the
   same way, and the checkpoint restored into a new experiment gives back
   the saved states bit for bit; the AsyncCheckpointer on the full-width
   'intent' state (``[ckpt] async``): the ms ``save()`` blocks against the
   seconds until the file lands, the file byte-identical to
   ``save_checkpoint``'s though every state tensor changes right after
   ``save()`` returns, keep 2 over three saves leaving two files;
   the model families through the trainer CLI at the JAX package's default
   width: birds (batch 256, 128×128×3, n_hidden 128, bf16) 2 epochs of 2
   synthetic steps, FID each epoch over 1000 samples against phase 4's
   statistics, its checkpoint saved; MNIST (batch 256, 28×28×1, latent
   7·7·4) 2 epochs of an idx pair of 4096 seeded images written here, FID
   'N/A'. Losses and FIDs finite, launches 0 fused_linear (every family
   dense layer is float32) and 2 per_image_normalize per birds FID epoch;
7. the FID phase once more, timed part by part (decode, normalize, pool3,
   Fréchet, PNG writes), with the decoder's BatchNorm running statistics
   checked unchanged by the sampling decode; the same for the birds
   generator at 128×128;
8. data: the JPEG decoder the card path uses (nvJPEG, its version and
   backend); the committed JPEG fixture decoded and resized on the card
   against the JAX package's 64×64 output for the same files (and PIL's
   full-resolution decode of four), mean |Δ| ≤ 1 and max |Δ| ≤ 8 grey
   levels at 64×64, max |Δ| ≤ 6 at full resolution; damaged files raise
   naming themselves; a class-subdirectory tree of 4096 copies of the
   fixture files through ``get_data_loader`` on the card, two epochs
   timed: the first fills the device cache, the second decodes nothing;
9. train on that tree: the β-VAE-GAN through the trainer CLI at full
   default width, 'observed', 2 epochs, FID each epoch against a
   directory of 512 of those JPEGs; losses and FIDs finite, launches
   checked as in phase 5, img/s per epoch; then the same 2 epochs without
   FID (the feed's rates without the FID's host work beside epoch 2); then
   the birds family one epoch of the tree at 128×128 with ImageNet's
   normalization, no FID;
10. FID statistics of a directory: ``statistics_from_dir`` over the 1000
   sample PNGs phase 7 wrote against statistics of the same uint8 arrays
   in memory, and ``get_fid`` of that directory against the .npz;
11. the six step kinds through ``cli/profile_step.py --model all``
   (``[time] graph``): ms/step by CUDA events, device busy time, idle
   share and kernels a step of the eager step, the one-step graph and
   ``make_multi_step`` with K = 8, each with the kind's fused_linear
   launches a step; the birds and MNIST eager rows also as ``[time] birds
   step`` / ``[time] mnist step`` with time by kernel category; the colour
   fixture decoded on the card (a CMYK, a YCCK, a 4:4:0 and a 4:1:1 file)
   against the host decode, max |Δ| ≤ 6;
12. the β search, the reproduction and the checkpoint conversion through
   their CLIs, at full default width on synthetic data with phase 4's
   statistics: ``cli.bo --posterior_only True`` against the GP computed
   here from the reference's observations; the search, 2 β evaluations of
   1 epoch of 2 steps with FID (2 distinct βs in [1, 150], 7 observations
   in ``bo_history.json``, each evaluation's wall seconds); ``--bo_parallel
   2`` on one card raising the ValueError naming 1 visible device;
   ``cli.reproduce`` (statistics, calibration, β=25 for 2 epochs of 2
   steps with FID, the report's fields, each part timed) and its
   ``--assets_check``; ``cli.fetch_assets`` (``[fetch]``), offline with
   ``--mnist`` (exit 1, the plan, nothing written), a ``file://``
   download installed with its sha256 prefix and refused with a wrong
   one, and phase 6's idx pair installed gzipped under the four MNIST
   names through ``_verify_idx``; a reference ``.tar`` written here at
   full width, converted by ``cli.convert`` (leaves checked against the
   layout rules) and resumed by the trainer for one epoch of 2 steps.
   Launches checked as in phase 5;
12b. data parallelism (parallel/mesh.py) on the one card: ``[ddp] nccl
   w1``, the full-width β-VAE-GAN 'observed' on the explicit group
   [cuda:0] over NCCL, world 1, 4 trainer steps (the first eager, then the
   one-step graph with its all-reduces captured), every metric and state
   tensor bit-identical to the same steps without a mesh, fused_linear 21
   launches a step; ``[ddp] gloo w2``, two spawned ranks sharing cuda:0
   over gloo, 3 eager steps of 128 rows a rank (a float32 control, then
   bf16 with bn_groups 1 and 2) against this process's steps on the whole
   256 within DDP_TOL of the dtype, the running statistics after the
   encoder's two heads and the KL term at every step within
   DDP_WALK_MULTIPLE times the JAX package's own two-device walk
   (JAX_WALK), the ranks' state bit-identical, 21 fused_linear launches a
   bf16 step on each rank; the ranks run under the port's float32 policy,
   as ``parallel.spawn`` starts them; ``[ddp]
   fid``, pool3 of 1000 full-width decodes split over those ranks against
   one process, one per_image_normalize launch a rank; ``[train] mesh``,
   the trainer with --mesh_shape 2 on one card raising the ValueError
   that names 1 visible device. The ranks report their launches, which
   the kernels line counts;
13. print the ``kernels`` JSON line, the card line and, last, the ok line.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, ".verify_runs", "chip_smoke")
BATCH = 256

# Peak rates of an H100 SXM (NVIDIA data sheet, dense): bytes/s of HBM3,
# bf16 tensor-core FLOP/s and float32 FLOP/s.
# bound = max(bytes / BW, flops / PEAK).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

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
# ... and of one step of each experiment (train/vae.py: the two encoder
# heads and the decoder's input layer; train/gan.py: G once, D three times,
# on x, on G(z) and on G(z) again for G's step)
STEP_SHAPES = {
    "betavaegan": FUSED_LINEAR_SHAPES,
    "vae": [("mu_fc1/lv_fc1", BATCH, 16384, 2048, "none", "bfloat16", 2),
            ("mu_fc2/lv_fc2", BATCH, 2048, 128, "none", "bfloat16", 2),
            ("preprocess", BATCH, 128, 16384, "none", "bfloat16", 1)],
    "gan": [("preprocess", BATCH, 128, 16384, "none", "bfloat16", 1),
            ("lth_features", BATCH, 16384, 2048, "leaky_relu", "bfloat16", 3),
            ("sigmoid_output", BATCH, 2048, 1, "none", "float32", 3)],
}
# the FID decode's one call per epoch: preprocess, 1000 latents
FID_DECODE_SHAPE = ("fid_decode/preprocess", 1000, 128, 16384, "none",
                    "bfloat16", 0)
# The evaluation sweep of one β-VAE-GAN checkpoint (train/loop.py
# _eval_sweep, batch_size_test 5): the FID decode, the reconstruction of the
# first test batch (both encoder heads, then the decoder) and the decode of
# the 5-sample grid. (role, M, K, N, activation, x dtype, calls per sweep)
TEST_BATCH = 5
SWEEP_SHAPES = [
    FID_DECODE_SHAPE[:-1] + (1,),
    ("recon/mu_fc1/lv_fc1", TEST_BATCH, 16384, 2048, "none", "bfloat16", 2),
    ("recon/mu_fc2/lv_fc2", TEST_BATCH, 2048, 128, "none", "bfloat16", 2),
    ("recon/preprocess", TEST_BATCH, 128, 16384, "none", "bfloat16", 1),
    ("samples/preprocess", TEST_BATCH, 128, 16384, "none", "bfloat16", 1),
]
# Shapes at the edges of fused_linear's paths (csrc/fused_linear.cu): batch
# rows around the stream path's 256-row tile, output features around its
# 128-row tile and the dot path's N < 64, and K = 2056 (33 slices of 64, the
# last with only its lower 32-float half in range; not a multiple of the 4,
# 8 or 16 splits these shapes get) or K = 24 (one half slice).
# (label, M, K, N, activation, x dtype name)
FUSED_LINEAR_EDGES = [
    ("M=1", 1, 16384, 2048, "none", "bfloat16"),
    ("M=255", 255, 2056, 2048, "relu", "bfloat16"),
    ("M=257", 257, 2056, 2048, "none", "bfloat16"),
    ("N=65", 256, 2056, 65, "leaky_relu", "bfloat16"),
    ("N=64", 256, 2056, 64, "none", "bfloat16"),
    ("N=63", 256, 2056, 63, "none", "bfloat16"),
    ("N=1", 256, 2056, 1, "none", "bfloat16"),
    ("K=24", 256, 24, 2048, "none", "bfloat16"),
]

# Tolerances, as a share of the plain output's largest magnitude. Both sides
# multiply the same bf16-rounded operands in float32; only the summation
# order differs, so a float32 output agrees to ~K·2⁻²⁴ and a bf16 output to
# one bf16 rounding (2⁻⁸). The backward runs bf16 GEMMs (kernel path) against
# float32 products rounded to bf16 (plain path): two bf16 roundings.
TOL_FWD = {"float32": 1e-4, "bfloat16": 8e-3}
TOL_GRAD = 2e-2

# per_image_normalize on the FID path: the decoder's N_SAMPLES images, NHWC,
# launched twice per FID epoch (Inception input, uint8 sample files).
N_SAMPLES = 1000
NORM_SHAPE = (N_SAMPLES, 64, 64, 3)
NORM_LAUNCHES_PER_EPOCH = 2
# the FID decode's one extra fused_linear launch: preprocess, 1000×128→16384
FID_FUSED_LINEAR_LAUNCHES = 1
# BatchNorm calls (ops/batchnorm.py launches: a call forward or backward is
# one) of one training step, train/vaegan.py, train/vae.py, train/gan.py:
# the encoder's five (bn1-3, mu_bn, lv_bn), the decoder's four (pre_bn,
# dbn1-3), the discriminator's four. The β-VAE-GAN 'observed' runs the
# encoder 2× forward and backward, the decoder 3× and 3×, the
# discriminator 5× and 4×: 42 + 38; 'intent' differentiates the encoder
# once less (75). The VAE: 9 + 9. The DCGAN: G 4 + 4, D 3 × 4 forward and
# 3 × 4 backward. The families' FlaxBatchNorm keeps its torch passes: 0.
BN_STEP_LAUNCHES = {"betavaegan observed": 80, "betavaegan intent": 75,
                    "vae": 18, "gan": 32, "birds": 0, "mnist": 0}
# ... of which run with the Swish (ops/batchnorm.py path_launches["swish"]):
# none of these models' BatchNorms (NVAE's BatchNorm-Swish has it, see
# nvae_step_launches); the evaluation, FID and data-parallel runs are held
# to 0 as well
BN_SWISH_LAUNCHES = {kind: 0 for kind in BN_STEP_LAUNCHES}
# NVAE's training run: the published global batch, and its steps (the first
# eager, the others graph replays)
NVAE_CONFIG = os.path.join(REPO, "h100_bench", "configs",
                           "nvae_celeba64.json")
NVAE_STEPS = 3
# ... and of sampling (train/common.py sampling: train-mode BatchNorm, no
# gradient): the FID decode runs the decoder's four once; the evaluation
# sweep adds the reconstruction's encoder and decoder (9) and the sample
# grid's decoder (4)
BN_FID_LAUNCHES = 4
BN_SWEEP_LAUNCHES = BN_FID_LAUNCHES + 9 + 4
# the copies the BatchNorm calls make before their passes (x to
# channels-last, dy to x's strides; ops/batchnorm.py path_launches
# ["copies"]): of the last counted run, and of every run; NVAE's step makes
# NVAE_BN_COPIES a step
BN_COPIES = {"last": 0, "total": 0}
NVAE_BN_COPIES = 0
# the depthwise convolutions' calls (ops/depthwise_conv.py path_launches) of
# the last counted run, and of every run: NVAE's step makes
# NVAE_DW_LAUNCHES a step, one forward and one backward each of its 72
# depthwise 5×5 (the reference's layer table); no other run makes any.
# ... and NVAE's peak reserved memory when cuDNN ran those convolutions
DW_LAUNCHES = {"last": {}, "total": 0}
NVAE_DW_LAUNCHES = {"fwd": 72, "bwd": 72}
NVAE_CUDNN_RESERVED_GB = 79.83
# [check] depthwise_conv: the largest error over the largest |value| of each
# output. Kernels against the plain version, both float32 sums of the same
# products in another order: float32 1e-5 (y, dx) and 1e-4 (dw, sums of
# N·H·W products that cancel); bf16 one bf16 step, both rounding float32
# sums once. Against F.conv2d (cuDNN) in bf16: one bf16 step for y and dx,
# 1e-2 for dw (cuDNN's own weight-gradient rounding)
TOL_DW = {"float32": {"y": 1e-5, "dx": 1e-5, "dw": 1e-4},
          "bfloat16": {"y": 2.0 ** -7, "dx": 2.0 ** -7, "dw": 2.0 ** -7},
          "library": {"y": 2.0 ** -7, "dx": 2.0 ** -7, "dw": 1e-2}}
# ... and on the birds FID path (train/loop.py run_family): 1000 decoded
# 128×128 samples, twice per FID epoch as well
BIRDS_IMG = 128
BIRDS_NORM_SHAPE = (N_SAMPLES, BIRDS_IMG, BIRDS_IMG, 3)
# Both sides compute (x − lo)·(1/range) in float32 from the same min and
# max, and the outputs lie in [0, 1].
TOL_NORM = 1e-6
# The families' runs: epochs, synthetic birds steps an epoch, and the MNIST
# idx images (for MNIST's 60,000)
FAMILY_EPOCHS = 2
BIRDS_STEPS = 2
MNIST_IMAGES = 16 * BATCH
# FID statistics of this many synthetic images, and the self-FID of those
# images against them. With equal activations only float64 rounding of the
# eigen math remains; its largest share is the square roots of the
# rounding-level eigenvalues of Σ's null space (rank ≤ n − 1), each about
# 1e-8 of the largest. A broken pipeline gives a self-FID of the order of
# tr(Σ).
STATS_IMAGES = 2048
TOL_SELF_FID = 1e-4
# pool3 on the card (float32, TF32 off) against pool3 on the CPU: the CPU
# parity tolerance against the JAX package (tests/test_torch_port_inception.py)
TOL_POOL3 = {"rtol": 2e-3, "atol": 2e-4}

# The data phases. The fixture: 16 CelebA-sized JPEGs with the JAX package's
# 64×64 load_batch_u8 of them and PIL's full-resolution decode of four
# (tests/test_torch_port_data.py writes it). The card upsamples and converts
# nvJPEG's planes with libjpeg's own arithmetic (data/native.py), so only
# the IDCT's rounding differs from libjpeg's, a level or so; the bar at
# 64×64 also holds nvJPEG's own colour conversion (which differs by up to
# 35 levels at full resolution, and by 8 after the 218→64 resize).
FIXTURE = os.path.join(REPO, "disentangle_mlp_tpu_torch", "data", "fixtures")
TOL_FIXTURE = {"mean": 1.0, "max": 8}
TOL_FIXTURE_FULL = 6
TREE_IMAGES = 16 * BATCH  # 16 full batches, copies of the fixture files
TREE_CLASSES = 4
FID_DIR_IMAGES = 512
FOLDER_EPOCHS = 2
# statistics of a directory of lossless PNGs against the same uint8 arrays
# in memory, pool3 in the same batches: only float64 rounding of the sums
# (Σx, Σxxᵀ against the centred product) remains
TOL_DIR_STATS = 1e-9


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


def tf32_on() -> bool:
    import torch

    return (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)


def tf32_state() -> str:
    import torch

    def word(on: bool) -> str:
        return "on" if on else "off"

    return (f"TF32 {word(torch.backends.cuda.matmul.allow_tf32)} for "
            f"matmuls, {word(torch.backends.cudnn.allow_tf32)} for cuDNN")


def need_float32(phase: str) -> None:
    """Fails ``phase``, a float32 one, if TF32 is on: the port's entry
    points leave both switches off (utils/runtime.py::float32_policy), and
    every float32 bound here holds float32 computed as float32."""
    if tf32_on():
        fail(f"{phase}: {tf32_state()} in a float32 phase; the port's entry "
             f"points leave both off")


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

    def fwd(label, x, w_kn, b, act, out, identity=False):
        """One launch against the plain version; with ``identity`` a second
        launch on the same inputs must give the same bits."""
        p = fl.plan_for(x, w_kn)
        got = fl.fused_linear(x, w_kn, b, act, out)
        want = fl.fused_linear_plain(x, w_kn, b, act, out)
        same = ""
        if identity:
            again = fl.fused_linear(x, w_kn, b, act, out)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"fused_linear {label} act={act} out={out}: two launches "
                     f"on the same inputs differ")
            same = ", two launches bit-identical"
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"fused_linear {label}: {got.dtype}{tuple(got.shape)} vs "
                 f"{want.dtype}{tuple(want.shape)}")
        if not torch.isfinite(got.float()).all():
            fail(f"fused_linear {label}: non-finite output")
        a, r = rel_err(got, want)
        tol = TOL_FWD[str(out).replace("torch.", "")]
        say(f"[check] fused_linear {label} act={act} out={out} path={p.path} "
            f"splits={p.splits}: max abs err {a:.3e}, rel {r:.3e} (tol "
            f"{tol:.0e}){same}")
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
    # the training step's shapes and the FID decode's, as the port calls
    # them: a float32 (N, K) weight read through its transpose
    for role, m, k, n, act, xdt, per_step in (
            FUSED_LINEAR_SHAPES + [FID_DECODE_SHAPE]
            + [s[:-1] + (0,) for s in SWEEP_SHAPES[1:4]]):
        x, w, b = inputs(m, k, n, getattr(torch, xdt))
        label = f"{role} {m}x{k}x{n}"
        for out in (torch.bfloat16, torch.float32):
            fwd(label, x, w.t(), b, act, out, identity=True)
        if per_step:  # the decode and the sweep run without gradients
            grad(label, x, w, b, act, torch.bfloat16)
        del x, w, b
    # NVAE's squeeze-excitation, every shape of its step
    for role, m, k, n, act, xdt, _ in nvae_linear_shapes():
        x, w, b = inputs(m, k, n, getattr(torch, xdt))
        label = f"{role} {m}x{k}x{n}"
        for out in (torch.bfloat16, torch.float32):
            fwd(label, x, w.t(), b, act, out, identity=True)
        grad(label, x, w, b, act, torch.bfloat16)
        del x, w, b
    for label, m, k, n, act, xdt in FUSED_LINEAR_EDGES:
        x, w, b = inputs(m, k, n, getattr(torch, xdt))
        for out in (torch.bfloat16, torch.float32):
            fwd(f"edge {label} {m}x{k}x{n}", x, w.t(), b, act, out)
        del x, w, b
    return worst


def time_device_ms(fn, iters: int = 20, tries: int = 4,
                   label: str = "") -> float:
    """Device time per call: a spin kernel holds the card until all the
    calls are queued, so the host's time per call does not show. The spin
    has to outlast the queuing, which takes longer when the host is busy:
    where it did not, the spin is doubled and the calls timed again, up to
    ``tries`` times; a call that waits for the device itself never lets
    the spin outlast it, and the line says so."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    cycles = 50_000_000  # tens of ms at the card's clock
    for _ in range(tries):
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = spin.elapsed_time(start)
        if spin_ms > queued_ms:
            break
        cycles *= 2
    else:
        say(f"[time] device-only time of {label or 'the next line'} "
            f"includes the host's: queuing {iters} calls took "
            f"{queued_ms:.1f} ms, the spin {spin_ms:.1f}")
    return start.elapsed_time(end) / iters


def time_fused_linear(fl, torch, card: str) -> list:
    """At each main-path shape and the FID decode's: the kernel, the plain
    version, the library (torch.addmm on bf16 copies made beforehand, then
    the activation) and the library with the casts it needs from the port's
    float32 weight (and float32 x), timed in turns; the kernel's and the
    library's device time alone; the bound and the achieved bytes/s. At
    K = 128 the generic path is timed too: the plan sends those shapes to
    the faster path."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for role, m, k, n, act, xdt, per_step in (FUSED_LINEAR_SHAPES
                                              + [FID_DECODE_SHAPE]):
        x = torch.randn(m, k, device=dev, generator=gen).to(getattr(torch,
                                                                   xdt))
        w = torch.randn(n, k, device=dev, generator=gen) * k ** -0.5
        b = torch.randn(n, device=dev, generator=gen) * 0.1
        w_kn, out = w.t(), torch.bfloat16
        x16, w16, b16 = x.bfloat16(), w_kn.bfloat16(), b.bfloat16()

        def activate(y):
            if act == "leaky_relu":
                y = torch.nn.functional.leaky_relu(y, 0.2)
            return y

        fns = {
            "kernel": lambda: fl.fused_linear(x, w_kn, b, act, out),
            "library": lambda: activate(torch.addmm(b16, x16, w16)),
            "library_cast": lambda: activate(torch.addmm(
                b16, x.to(torch.bfloat16), w_kn.to(torch.bfloat16))),
            "plain": lambda: fl.fused_linear_plain(x, w_kn, b, act, out),
        }
        order = ["kernel", "library", "library_cast", "plain"]
        times = {key: [] for key in order}
        for key in order + order[::-1]:
            times[key].append(time_ms(fns[key]))
        ms = {key: sum(v) / len(v) for key, v in times.items()}
        device_ms = time_device_ms(fns["kernel"])
        library_device_ms = time_device_ms(fns["library"])
        p = fl.plan_for(x, w_kn)
        generic_ms = None
        if k == 128:
            generic = fl.Plan("generic", 1, 0)
            generic_ms = time_ms(lambda: fl._launch(x, w_kn, b, act, out,
                                                    force=generic))
        nbytes = (x.numel() * x.element_size() + w.numel() * 4
                  + b.numel() * 4 + m * n * 2)
        flops = 2 * m * n * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        rows.append({
            "role": role, "M": m, "K": k, "N": n, "activation": act,
            "x_dtype": xdt, "w_dtype": "float32", "out_dtype": "bfloat16",
            "path": p.path, "splits": p.splits,
            "workspace_bytes": p.workspace_bytes,
            "launches_per_step": per_step, "bytes": nbytes, "flops": flops,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "library_cast_ms": ms["library_cast"],
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "generic_path_ms": generic_ms,
            "achieved_bytes_per_s": nbytes / (ms["kernel"] * 1e-3),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        r = rows[-1]
        say(f"[time] fused_linear {role} {m}x{k}x{n} path={p.path} "
            f"splits={p.splits}: kernel {r['ms']:.4f} ms "
            f"({r['achieved_bytes_per_s'] / 1e12:.2f} TB/s), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"library with casts {r['library_cast_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); device only: kernel "
            f"{device_ms:.4f} ms, library {library_device_ms:.4f} ms"
            + (f"; generic path {generic_ms:.4f} ms" if generic_ms else "")
            + f"; card {card}")
        del x, w, b, x16, w16, b16
    return rows


def ptxas_summary(log: str) -> str:
    """Registers and spills of each kernel in an ``nvcc -Xptxas=-v`` log
    (one entry per kernel name and count), and any wgmma serialisation."""
    names = ("fused_linear_stream_kernel", "fused_linear_splitk_reduce_kernel",
             "fused_linear_dot_kernel", "fused_linear_generic_kernel",
             "per_image_normalize", "dmt_bn_reduce_rows",
             "dmt_bn_reduce_grad_rows", "dmt_bn_reduce_finalize",
             "dmt_bn_reduce_grad_finalize", "dmt_bn_elementwise_apply_rows",
             "dmt_bn_elementwise_grad_rows", "dmt_bn_reduce_ring",
             "dmt_bn_reduce_grad_ring", "dmt_bn_elementwise_apply_ring",
             "dmt_bn_elementwise_grad_ring", "dmt_dwconv_fwd",
             "dmt_dwconv_bwd_finalize", "dmt_dwconv_bwd")
    seen, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in names if k in line), "other")
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "registers" in line and "Used" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            seen.setdefault(f"{name} {regs} registers, {spill}", None)
            name = None
        elif "serialized" in line:
            seen.setdefault("WARNING " + line.split(":", 1)[-1].strip(), None)
    return "; ".join(seen)


def check_per_image_normalize(pin, torch) -> float:
    """The kernel against per_image_normalize_plain: output dtype, shape,
    strides, NaN positions and values; returns the largest error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0

    def images(n, h, w, c, dtype, nchw):
        """Values in (-1, 1) like the decoder's tanh; with ``nchw`` the
        NHWC view of a contiguous NCHW tensor, as the decoder returns."""
        shape = (n, c, h, w) if nchw else (n, h, w, c)
        x = torch.tanh(2.0 * torch.randn(shape, device=dev, generator=gen))
        x = x.to(dtype)
        return x.permute(0, 2, 3, 1) if nchw else x

    def check(label, x):
        nonlocal worst
        got = pin.per_image_normalize(x)
        want = pin.per_image_normalize_plain(x)
        torch.cuda.synchronize()
        if (got.dtype != torch.float32 or got.shape != x.shape
                or got.stride() != x.stride()):
            fail(f"per_image_normalize {label}: {got.dtype} "
                 f"{tuple(got.shape)} strides {got.stride()}, want float32 "
                 f"{tuple(x.shape)} strides {x.stride()}")
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            fail(f"per_image_normalize {label}: NaN positions differ from "
                 f"the plain version")
        err = (got - want).abs()[~nan].max().item() if bool((~nan).any()) \
            else 0.0
        say(f"[check] per_image_normalize {label}: max abs err {err:.3e} "
            f"(tol {TOL_NORM:.0e})")
        if not err <= TOL_NORM:
            fail(f"per_image_normalize {label}: max abs err {err:.3e} > "
                 f"{TOL_NORM:.0e}")
        worst = max(worst, err)
        return got

    n, h, w, c = NORM_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for nchw in (True, False):
            layout = "NHWC view of NCHW" if nchw else "contiguous NHWC"
            check(f"{NORM_SHAPE} {name} {layout}",
                  images(n, h, w, c, dtype, nchw))
            check(f"odd (3, 5, 7, 3) {name} {layout}",
                  images(3, 5, 7, 3, dtype, nchw))
        # 786 KB a float32 image: above the shared-memory stage, read twice
        check(f"large (2, 256, 256, 3) {name}",
              images(2, 256, 256, 3, dtype, False))
    # the birds FID path's shape: the decoder's bf16 (96 KB staged an
    # image), and float32 contiguous (192 KB, the largest stage it takes)
    for dtype, nchw in ((torch.bfloat16, True), (torch.float32, False)):
        layout = "NHWC view of NCHW" if nchw else "contiguous NHWC"
        check(f"birds {BIRDS_NORM_SHAPE} {str(dtype)[6:]} {layout}",
              images(*BIRDS_NORM_SHAPE, dtype, nchw))
    x = images(4, h, w, c, torch.float32, False)
    x[1] = 0.25
    y = check("constant image 1 of 4", x)
    if not bool((y[1] == 0).all()):
        fail("per_image_normalize: a constant image must map to 0")
    x = images(4, h, w, c, torch.bfloat16, True)
    x[2, 10, 20, 1] = float("nan")
    y = check("one NaN in image 2 of 4", x)
    if not (bool(torch.isnan(y[2]).all())
            and bool(torch.isfinite(y[[0, 1, 3]]).all())):
        fail("per_image_normalize: the NaN image must come out all NaN and "
             "the others finite")
    return worst


def time_per_image_normalize(pin, torch, card: str) -> list:
    """Kernel (back-to-back launches, and device-only) and plain times at
    the FID paths' inputs: the decoder's bf16 NHWC view of NCHW at the
    CelebA and the birds shapes, and float32 contiguous at the birds shape.
    No single PyTorch call computes this function, so there is no library
    time."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for shape, dtype, nchw in ((NORM_SHAPE, torch.bfloat16, True),
                               (BIRDS_NORM_SHAPE, torch.bfloat16, True),
                               (BIRDS_NORM_SHAPE, torch.float32, False)):
        n, h, w, c = shape
        if nchw:
            x = torch.tanh(torch.randn((n, c, h, w), device=dev,
                                       generator=gen)).to(dtype)
            x = x.permute(0, 2, 3, 1)
        else:
            x = torch.tanh(torch.randn(shape, device=dev,
                                       generator=gen)).to(dtype)
        kernel_ms = time_ms(lambda: pin.per_image_normalize(x))
        device_ms = time_device_ms(lambda: pin.per_image_normalize(x))
        plain_ms = time_ms(lambda: pin.per_image_normalize_plain(x))
        nbytes = x.numel() * (x.element_size() + 4)  # x in, float32 out
        flops = 4 * x.numel()  # min, max, subtract, multiply
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        layout = "NHWC view of NCHW" if nchw else "contiguous NHWC"
        dt = str(dtype).replace("torch.", "")
        rows.append({"shape": list(shape), "x_dtype": dt, "layout": layout,
                     "bytes": nbytes, "flops": flops, "ms": kernel_ms,
                     "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"})
        r = rows[-1]
        say(f"[time] per_image_normalize {shape} {dt} {layout}: kernel "
            f"{kernel_ms:.4f} ms, device only {device_ms:.4f} ms "
            f"({nbytes / (device_ms * 1e-3) / 1e12:.2f} TB/s), plain "
            f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); no library call; card {card}")
        del x
    return rows


def batchnorm_tests():
    """tests/test_torch_port_batchnorm.py as a top-level module (another
    package named ``tests`` may be installed): its table of the step's
    BatchNorm shapes, its inputs and its comparison."""
    path = os.path.join(REPO, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import test_torch_port_batchnorm as bnt

    return bnt


def nvae_reference() -> tuple:
    """(h100_bench/reference/nvae.py, the nvae_celeba64 configuration): the
    plain reference's tables of NVAE's BatchNorm and dense calls."""
    path = os.path.join(REPO, "h100_bench")
    if path not in sys.path:
        sys.path.insert(0, path)
    from reference import nvae

    with open(NVAE_CONFIG) as f:
        return nvae, json.load(f)


def nvae_batchnorm_shapes() -> list:
    """((B, C, H, W), activation) of each distinct BatchNorm call of NVAE's
    step at batch B."""
    return [(s, a) for s, a, _ in nvae_batchnorm_calls()]


def nvae_batchnorm_calls() -> list:
    """((B, C, H, W), activation, calls a step each way) of NVAE's step, the
    reference's ``batchnorm_calls`` by shape."""
    ref, c = nvae_reference()
    b, calls = c["batch_size_train"], {}
    for l in ref.layers(c):
        if l["kind"] == "bn":
            key = ((b, l["features"], l["hw"], l["hw"]), l["act"])
            calls[key] = calls.get(key, 0) + 1
    return [k + (n,) for k, n in sorted(calls.items())]


def nvae_linear_shapes() -> list:
    """(role, M, K, N, activation, x dtype, calls a step) of NVAE's dense
    calls, each cell's squeeze-excitation (models/nvae.py SE: ReLU after
    fc1, none after fc2, a bf16 mean of the pixels in), as planned_paths
    and check_fused_linear take them."""
    ref, c = nvae_reference()
    b, calls = c["batch_size_train"], {}
    for l in ref.layers(c):
        if l["kind"] != "linear" or l.get("derived"):
            continue
        role = l["name"].rsplit(".", 1)[1]
        key = (f"nvae se.{role}", b, l["fin"], l["fout"],
               "relu" if role == "fc1" else "none", "bfloat16")
        calls[key] = calls.get(key, 0) + 1
    return [k + (n,) for k, n in sorted(calls.items())]


def check_batchnorm(bno, torch) -> dict:
    """The BatchNorm kernels against their plain passes on the same card
    tensors at every BatchNorm shape of the β-VAE-GAN step (batch 256,
    bf16, train mode, the module's activation) and at every shape and
    activation of NVAE's step (batch 128), channels-last as the steps
    give them: y, dx, dγ, dβ and the running statistics within the test
    file's tolerances (its docstring gives each reason), and two launches
    bit-identical. Returns the largest reading over its tolerance of each
    output."""
    bnt = batchnorm_tests()
    dev = torch.device("cuda")
    worst: dict = {}
    cases = [(s, a) for s, a, _, _ in bnt.STEP_SHAPES] + \
        nvae_batchnorm_shapes()
    for i, (shape, act) in enumerate(cases):
        x = bnt._input(shape, dev, 10 + i, torch.bfloat16, True)
        dy = bnt._input(shape, dev, 50 + i, torch.bfloat16, True)
        state = bnt._params(shape[1], dev, i)
        got = bnt._run(bno.batch_norm, x, dy, state, act)
        again = bnt._run(bno.batch_norm, x, dy, state, act)
        want = bnt._run(bno.batch_norm_plain, x, dy, state, act)
        torch.cuda.synchronize()
        same = [k for k in got if torch.equal(got[k], again[k])]
        err = bnt.compare(got, want, x, state)
        for k, v in err.items():
            worst[k] = max(worst.get(k, 0), v)
        say(f"[check] batchnorm {shape} {act}: error over tolerance "
            + ", ".join(f"{k} {v:.3f}" for k, v in err.items()
                        if k != "kink")
            + f"; dx left out at the kink {err['kink']}; two launches "
            f"bit-identical in {len(same)} of {len(got)} outputs")
        if len(same) != len(got):
            fail(f"[check] batchnorm {shape}: two launches differ in "
                 f"{sorted(set(got) - set(same))}")
        if max(v for k, v in err.items() if k != "kink") > 1 or \
                err["kink"] > 1e-3 * x.numel():
            fail(f"[check] batchnorm {shape} {act}: {err}")
        del x, dy, got, again, want
    return worst


def aten_batchnorm(x, w, b, rm, rv, act: str):
    """The ATen passes the BatchNorm kernels replace (models/layers.py
    before them: a float32 copy, mean, square and mean, the clip, rsqrt,
    the fold, the running statistics, a compute-dtype multiply and add),
    then the activation as its own pass."""
    import torch
    import torch.nn.functional as F

    axes = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    mean, mean2 = xf.mean(axes), xf.square().mean(axes)
    n = x.numel() // x.shape[1]
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    with torch.no_grad():
        rm.copy_(0.9 * rm + 0.1 * mean)
        rv.copy_(0.9 * rv + 0.1 * var * (n / (n - 1)))
    inv = torch.rsqrt(var + 1e-5) * w
    shift = b - mean * inv
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
    return F.relu(y) if act == "relu" else F.leaky_relu(y, 0.2)


def library_batchnorm(x, w, b, rm, rv, act: str):
    """The library's one call each way: ``F.batch_norm`` in train mode
    (cuDNN's or ATen's fused channels-last BatchNorm, a Welford variance)
    and the activation in place, as ``nn.BatchNorm2d`` and
    ``nn.ReLU(inplace=True)`` give them."""
    import torch.nn.functional as F

    y = F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1,
                     eps=1e-5)
    return F.relu(y, inplace=True) if act == "relu" else \
        F.leaky_relu(y, 0.2, inplace=True)


def time_batchnorm(bno, torch, card: str) -> dict:
    """At each BatchNorm shape of the β-VAE-GAN step (channels-last bf16,
    as the step gives them), forward alone and forward with backward: the
    kernels' wall time a call (CUDA events, queued calls) and device-only
    time, the plain passes', the library call's (``library_batchnorm``) and
    the ATen chain's the kernels replace (with its separate activation).
    Two bounds at 3.35 TB/s, the C-sized vectors left out: ``bound``, the
    bytes the function has to move (forward x in and y out, backward x and
    dy in and dx out), and ``two_pass_bound``, this design's own (x, and
    dy, read twice). Then the sums over one step's calls (forward and
    backward counts of the table)."""
    bnt = batchnorm_tests()
    dev = torch.device("cuda")
    rows = []
    for i, (shape, act, nf, nb) in enumerate(bnt.STEP_SHAPES):
        x = bnt._input(shape, dev, 10 + i, torch.bfloat16, True)
        dy = bnt._input(shape, dev, 50 + i, torch.bfloat16, True)
        w, b, rm, rv = bnt._params(shape[1], dev, i)
        w.requires_grad_(), b.requires_grad_()
        xg = x.detach().clone().requires_grad_()

        def fwd(fn):
            with torch.no_grad():
                return fn(x, w, b, rm, rv, act)

        def both(fn):  # the gradients alone: nothing accumulated into .grad
            torch.autograd.grad(fn(xg, w, b, rm, rv, act), (xg, w, b), dy)

        def ours(xx, *a):
            return bno.batch_norm(xx, *a[:4], train=True, activation=a[4])

        def plain(xx, *a):
            return bno.batch_norm_plain(xx, *a[:4], train=True,
                                        activation=a[4])

        timed = (("kernel", ours), ("library", library_batchnorm),
                 ("aten", aten_batchnorm))
        ms = {}
        for name, fn in timed + (("plain", plain),):
            ms[name + "_fwd"] = time_ms(lambda: fwd(fn))
            ms[name + "_both"] = time_ms(lambda: both(fn))
        for name, fn in timed:
            label = f"batchnorm {name} {tuple(shape)}"
            ms[name + "_fwd_device"] = time_device_ms(
                lambda: fwd(fn), label=label + " forward")
            ms[name + "_both_device"] = time_device_ms(
                lambda: both(fn), label=label + " both")
        nbytes = x.element_size() * x.numel()
        r = {"shape": list(shape), "activation": act, "forward_calls": nf,
             "backward_calls": nb, "forward_bytes": 2 * nbytes,
             "backward_bytes": 3 * nbytes,
             "forward_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
             "backward_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
             "forward_two_pass_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
             "backward_two_pass_bound_ms": 5 * nbytes / HBM_BYTES_PER_S
             * 1e3, **ms}
        for name in ("kernel", "plain", "library", "aten"):
            r[name + "_bwd"] = ms[name + "_both"] - ms[name + "_fwd"]
        for name, _ in timed:
            r[name + "_bwd_device"] = (ms[name + "_both_device"]
                                       - ms[name + "_fwd_device"])
        rows.append(r)
        say(f"[time] batchnorm {tuple(shape)} {act}: forward kernel "
            f"{ms['kernel_fwd']:.4f} ms (device {ms['kernel_fwd_device']:.4f}"
            f", bound {r['forward_bound_ms']:.4f}, "
            f"{r['forward_bound_ms'] / ms['kernel_fwd_device'] * 100:.1f} %; "
            f"two-pass bound {r['forward_two_pass_bound_ms']:.4f}), library "
            f"{ms['library_fwd']:.4f} (device "
            f"{ms['library_fwd_device']:.4f}), ATen chain "
            f"{ms['aten_fwd']:.4f} (device {ms['aten_fwd_device']:.4f}), "
            f"plain {ms['plain_fwd']:.4f}; backward kernel "
            f"{r['kernel_bwd']:.4f} ms (device {r['kernel_bwd_device']:.4f}, "
            f"bound {r['backward_bound_ms']:.4f}, "
            f"{r['backward_bound_ms'] / r['kernel_bwd_device'] * 100:.1f} %; "
            f"two-pass bound {r['backward_two_pass_bound_ms']:.4f}), library "
            f"{r['library_bwd']:.4f} (device {r['library_bwd_device']:.4f}), "
            f"ATen chain {r['aten_bwd']:.4f} (device "
            f"{r['aten_bwd_device']:.4f}), plain {r['plain_bwd']:.4f}; "
            f"card {card}")
        del x, dy, xg

    def total(fwd_key, bwd_key):
        return sum(r[fwd_key] * r["forward_calls"]
                   + r[bwd_key] * r["backward_calls"] for r in rows)

    step = {"plain_ms": total("plain_fwd", "plain_bwd")}
    for name, _ in timed:
        step[name + "_ms"] = total(name + "_fwd", name + "_bwd")
        step[name + "_device_ms"] = total(name + "_fwd_device",
                                          name + "_bwd_device")
    step["bound_ms"] = total("forward_bound_ms", "backward_bound_ms")
    step["two_pass_bound_ms"] = total("forward_two_pass_bound_ms",
                                      "backward_two_pass_bound_ms")
    step["bound_share"] = step["bound_ms"] / step["kernel_device_ms"]
    step["two_pass_bound_share"] = (step["two_pass_bound_ms"]
                                    / step["kernel_device_ms"])
    say(f"[time] batchnorm per betavaegan step "
        f"({sum(r['forward_calls'] for r in rows)} forward and "
        f"{sum(r['backward_calls'] for r in rows)} backward calls): kernels "
        f"{step['kernel_ms']:.3f} ms, device only "
        f"{step['kernel_device_ms']:.3f} ms, bound {step['bound_ms']:.3f} "
        f"ms ({step['bound_share'] * 100:.1f} % of it; two-pass bound "
        f"{step['two_pass_bound_ms']:.3f} ms, "
        f"{step['two_pass_bound_share'] * 100:.1f} %), library "
        f"{step['library_ms']:.3f} ms (device "
        f"{step['library_device_ms']:.3f}), plain {step['plain_ms']:.3f} ms, "
        f"ATen chain {step['aten_ms']:.3f} ms (device "
        f"{step['aten_device_ms']:.3f}); card {card}")
    return {"shapes": rows, "per_step": step}


def time_batchnorm_nvae(bno, torch, card: str) -> dict:
    """At each BatchNorm shape of NVAE's step (batch 128, bf16
    channels-last, train mode, its activation): the kernels' device-only
    time a call forward and backward, against the bytes the function has
    to move at 3.35 TB/s and against the two-pass design's (as
    ``time_batchnorm``); then both summed over one step's calls, weighted
    by each shape's count. The plain, library and ATen versions are timed
    at the β-VAE-GAN's shapes only."""
    bnt = batchnorm_tests()
    dev = torch.device("cuda")
    rows = []
    for i, (shape, act, n) in enumerate(nvae_batchnorm_calls()):
        x = bnt._input(shape, dev, 110 + i, torch.bfloat16, True)
        dy = bnt._input(shape, dev, 150 + i, torch.bfloat16, True)
        w, b, rm, rv = bnt._params(shape[1], dev, 40 + i)
        w.requires_grad_(), b.requires_grad_()
        xg = x.detach().clone().requires_grad_()

        def fwd():
            with torch.no_grad():
                return bno.batch_norm(x, w, b, rm, rv, train=True,
                                      activation=act)

        def both():
            y = bno.batch_norm(xg, w, b, rm, rv, train=True, activation=act)
            torch.autograd.grad(y, (xg, w, b), dy)

        label = f"batchnorm nvae {shape} {act}"
        fwd_ms = time_device_ms(fwd, label=label + " forward")
        bwd_ms = time_device_ms(both, label=label + " both") - fwd_ms
        nbytes = x.element_size() * x.numel()
        r = {"shape": list(shape), "activation": act, "calls": n,
             "forward_device_ms": fwd_ms, "backward_device_ms": bwd_ms,
             "forward_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
             "backward_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
             "forward_two_pass_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
             "backward_two_pass_bound_ms": 5 * nbytes / HBM_BYTES_PER_S
             * 1e3}
        rows.append(r)
        say(f"[time] batchnorm nvae {tuple(shape)} {act} x{n}: forward "
            f"device {fwd_ms:.4f} ms (bound {r['forward_bound_ms']:.4f}, "
            f"{r['forward_bound_ms'] / fwd_ms * 100:.1f} %; two-pass "
            f"{r['forward_two_pass_bound_ms'] / fwd_ms * 100:.1f} %), "
            f"backward device {bwd_ms:.4f} ms (bound "
            f"{r['backward_bound_ms']:.4f}, "
            f"{r['backward_bound_ms'] / bwd_ms * 100:.1f} %; two-pass "
            f"{r['backward_two_pass_bound_ms'] / bwd_ms * 100:.1f} %); "
            f"card {card}")
        del x, dy, xg

    def total(key):
        return sum(r[key] * r["calls"] for r in rows)

    step = {k: total(k) for k in (
        "forward_device_ms", "backward_device_ms", "forward_bound_ms",
        "backward_bound_ms", "forward_two_pass_bound_ms",
        "backward_two_pass_bound_ms")}
    step["device_ms"] = step["forward_device_ms"] + \
        step["backward_device_ms"]
    step["bound_ms"] = step["forward_bound_ms"] + step["backward_bound_ms"]
    step["two_pass_bound_ms"] = (step["forward_two_pass_bound_ms"]
                                 + step["backward_two_pass_bound_ms"])
    calls = sum(r["calls"] for r in rows)
    say(f"[time] batchnorm per nvae step ({calls} forward and {calls} "
        f"backward calls): device {step['device_ms']:.3f} ms (forward "
        f"{step['forward_device_ms']:.3f}, backward "
        f"{step['backward_device_ms']:.3f}), bound {step['bound_ms']:.3f} ms "
        f"({step['bound_ms'] / step['device_ms'] * 100:.1f} %), two-pass "
        f"bound {step['two_pass_bound_ms']:.3f} ms "
        f"({step['two_pass_bound_ms'] / step['device_ms'] * 100:.1f} %); "
        f"card {card}")
    return {"shapes": rows, "per_step": step}


def nvae_depthwise_calls() -> list:
    """((B, C, H, W), k, calls a step) of NVAE's depthwise convolutions, the
    reference's layer table by shape."""
    ref, c = nvae_reference()
    b, calls = c["batch_size_train"], {}
    for l in ref.layers(c):
        if l["kind"] == "conv" and l["groups"] > 1:
            key = ((b, l["groups"], l["hw_in"], l["hw_in"]), l["k"])
            calls[key] = calls.get(key, 0) + 1
    return [k + (n,) for k, n in sorted(calls.items())]


def _dw_inputs(shape, k, seed, dtype, torch):
    """x, w, dy on the card, x and dy channels-last."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = (torch.randn(shape, generator=g, device="cuda").to(dtype)
             .contiguous(memory_format=torch.channels_last) for _ in (0, 1))
    w = (0.2 * torch.randn((shape[1], 1, k, k), generator=g,
                           device="cuda")).to(dtype)
    return x, w, dy


def _dw_run(fn, x, w, dy, torch) -> dict:
    xg = x.detach().clone().requires_grad_()
    wg = w.detach().clone().requires_grad_()
    y = fn(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    return {"y": y.detach(), "dx": dx, "dw": dw}


def _dw_library(x, w):
    import torch.nn.functional as F

    return F.conv2d(x, w, None, 1, (w.shape[-1] - 1) // 2, 1, x.shape[1])


def check_depthwise(dwc, torch) -> dict:
    """The depthwise kernels at each of NVAE's seven shapes (batch 128):
    float32 kernels against the plain version in float32, bf16 kernels
    against the plain version in bf16 and against ``F.conv2d`` (cuDNN) in
    bf16, y, dx and dw each within ``TOL_DW``; two launches bit-identical
    (dw included). Returns each comparison's largest reading over its
    tolerance."""
    worst: dict = {}
    for i, (shape, k, n) in enumerate(nvae_depthwise_calls()):
        parts = []
        for dtype, ref, key in (
                (torch.float32, dwc.depthwise_conv_plain, "float32"),
                (torch.bfloat16, dwc.depthwise_conv_plain, "bfloat16"),
                (torch.bfloat16, _dw_library, "library")):
            x, w, dy = _dw_inputs(shape, k, 300 + i, dtype, torch)
            got = _dw_run(dwc.depthwise_conv, x, w, dy, torch)
            want = _dw_run(ref, x, w, dy, torch)
            if key != "library":
                again = _dw_run(dwc.depthwise_conv, x, w, dy, torch)
                torch.cuda.synchronize()
                differ = [o for o in got if not torch.equal(got[o],
                                                            again[o])]
                if differ:
                    fail(f"[check] depthwise_conv {shape} {key}: two launches "
                         f"differ in {differ}")
            torch.cuda.synchronize()
            if not got["y"].is_contiguous(memory_format=torch.channels_last) \
                    or not got["dx"].is_contiguous(
                        memory_format=torch.channels_last):
                fail(f"[check] depthwise_conv {shape}: y or dx not "
                     f"channels-last")
            over = {}
            for o in ("y", "dx", "dw"):
                d, rel = rel_err(got[o], want[o])
                over[o] = rel / TOL_DW[key][o]
                worst[f"{key} {o}"] = max(worst.get(f"{key} {o}", 0),
                                          over[o])
            parts.append(f"{key} " + ", ".join(f"{o} {v:.3f}"
                                               for o, v in over.items()))
            if max(over.values()) > 1:
                fail(f"[check] depthwise_conv {shape} {key}: error over "
                     f"tolerance {over}")
            del x, w, dy, got, want
        say(f"[check] depthwise_conv {shape} k {k} x{n}: error over "
            f"tolerance (largest |Δ| ÷ largest |value| ÷ TOL_DW) "
            + "; ".join(parts) + "; two launches bit-identical (float32, "
            "bf16; dw included)")
    return worst


def time_depthwise_nvae(dwc, torch, card: str) -> dict:
    """At each of NVAE's depthwise shapes (batch 128, bf16 channels-last):
    the kernels' device-only time a call forward and backward (its finalize
    included), ``F.conv2d`` (cuDNN, ``library``) and the plain version, each
    way, against the bytes the function has to move (4 B an element
    forward, 6 B backward) at 3.35 TB/s; the backward's split between its
    fused pass and its finalize from the profiler; then all summed over one
    step's calls."""
    rows = []
    for i, (shape, k, n) in enumerate(nvae_depthwise_calls()):
        x, w, dy = _dw_inputs(shape, k, 400 + i, torch.bfloat16, torch)
        xg = x.detach().clone().requires_grad_()
        wg = w.detach().clone().requires_grad_()
        label = f"depthwise_conv nvae {shape}"
        r = {"shape": list(shape), "k": k, "calls": n}
        for name, fn in (("kernel", dwc.depthwise_conv),
                         ("library", _dw_library),
                         ("plain", dwc.depthwise_conv_plain)):
            def fwd():
                with torch.no_grad():
                    return fn(x, w)

            def both():
                y = fn(xg, wg)
                torch.autograd.grad(y, (xg, wg), dy)

            iters = 20 if name != "plain" else 3
            f_ms = time_device_ms(fwd, iters, label=f"{label} {name} fwd")
            b_ms = time_device_ms(both, iters,
                                  label=f"{label} {name} both") - f_ms
            r[f"{name}_forward_ms"], r[f"{name}_backward_ms"] = f_ms, b_ms
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                acc_events=True) as prof:
            for _ in range(5):
                y = dwc.depthwise_conv(xg, wg)
                torch.autograd.grad(y, (xg, wg), dy)
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            for part in ("dmt_dwconv_fwd", "dmt_dwconv_bwd_finalize",
                         "dmt_dwconv_bwd"):
                if part in e.key:
                    t = getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0))
                    by[part] = by.get(part, 0.0) + t / 5e3
                    break
        r["profiled_ms"] = by
        elems = x.numel()
        r["forward_bound_ms"] = 4 * elems / HBM_BYTES_PER_S * 1e3
        r["backward_bound_ms"] = 6 * elems / HBM_BYTES_PER_S * 1e3
        rows.append(r)
        say(f"[time] depthwise_conv nvae {tuple(shape)} k {k} x{n}: forward "
            f"device {r['kernel_forward_ms']:.4f} ms (bound "
            f"{r['forward_bound_ms']:.4f}, "
            f"{r['forward_bound_ms'] / r['kernel_forward_ms'] * 100:.1f} %; "
            f"library {r['library_forward_ms']:.4f}, plain "
            f"{r['plain_forward_ms']:.4f}), backward device "
            f"{r['kernel_backward_ms']:.4f} ms (bound "
            f"{r['backward_bound_ms']:.4f}, "
            f"{r['backward_bound_ms'] / r['kernel_backward_ms'] * 100:.1f} %; "
            f"library {r['library_backward_ms']:.4f}, plain "
            f"{r['plain_backward_ms']:.4f}); profiled ms a call "
            + ", ".join(f"{kk} {v:.4f}" for kk, v in by.items())
            + f"; card {card}")
        del x, w, dy, xg, wg

    def total(key):
        return sum(r[key] * r["calls"] for r in rows)

    step = {key: total(key) for key in rows[0]
            if key.endswith("_ms") and key != "profiled_ms"}
    step["profiled_ms"] = {kk: sum(r["profiled_ms"].get(kk, 0) * r["calls"]
                                   for r in rows)
                           for kk in rows[0]["profiled_ms"]}
    for name in ("kernel", "library", "plain"):
        step[f"{name}_ms"] = step[f"{name}_forward_ms"] + \
            step[f"{name}_backward_ms"]
    step["bound_ms"] = step["forward_bound_ms"] + step["backward_bound_ms"]
    calls = sum(r["calls"] for r in rows)
    say(f"[time] depthwise_conv per nvae step ({calls} forward and {calls} "
        f"backward calls): kernel {step['kernel_ms']:.3f} ms (forward "
        f"{step['kernel_forward_ms']:.3f}, backward "
        f"{step['kernel_backward_ms']:.3f}; profiled "
        + ", ".join(f"{kk} {v:.3f}" for kk, v in step["profiled_ms"].items())
        + f"), bound {step['bound_ms']:.3f} ms "
        f"({step['bound_ms'] / step['kernel_ms'] * 100:.1f} %; forward "
        f"{step['forward_bound_ms']:.3f}, backward "
        f"{step['backward_bound_ms']:.3f}), library_ms "
        f"{step['library_ms']:.3f} (forward {step['library_forward_ms']:.3f}, "
        f"backward {step['library_backward_ms']:.3f}), plain "
        f"{step['plain_ms']:.3f}; card {card}")
    return {"shapes": rows, "per_step": step}


def fid_setup(torch) -> str:
    """Reference statistics of STATS_IMAGES synthetic images through the
    port's compute_dataset_statistics; the same images against them give
    |FID| ≈ 0; pool3 on the card agrees with the CPU. Returns the .npz."""
    import numpy as np

    from disentangle_mlp_tpu_torch.data.pipeline import (DataLoader,
                                                         SyntheticSource)
    from disentangle_mlp_tpu_torch.eval import fid
    from disentangle_mlp_tpu_torch.eval.inception import (get_params_cached,
                                                          pool3_features)
    from disentangle_mlp_tpu_torch.utils.params import inception_from_jax

    os.makedirs(RUN_DIR, exist_ok=True)
    path = os.path.join(RUN_DIR, "fid_stats.npz")
    loader = DataLoader(SyntheticSource(size=STATS_IMAGES, seed=0), BATCH,
                        shuffle=False, device="cuda")
    t0 = time.perf_counter()
    mu, sigma = fid.compute_dataset_statistics(loader, path,
                                               max_images=STATS_IMAGES)
    t_stats = time.perf_counter() - t0
    acts = np.concatenate([fid.get_activations((x + 1.0) / 2.0)
                           for x, _ in loader])
    self_fid = fid.frechet_from_acts(
        acts, mu, sigma, sqrt_sigma2=fid.cached_sqrt_sigma2(path, sigma))
    tr = float(np.trace(sigma))
    if not (acts.shape == (STATS_IMAGES, fid.FEATURE_DIM)
            and np.isfinite(acts).all() and math.isfinite(self_fid)):
        fail(f"fid: activations {acts.shape} or self-FID {self_fid} not "
             f"finite and of the expected shape")
    if abs(self_fid) > TOL_SELF_FID * tr:
        fail(f"fid: self-FID {self_fid:.3e} exceeds {TOL_SELF_FID:.0e} x "
             f"tr(sigma) {tr:.3e}")
    x01 = (next(iter(loader))[0][:2] + 1.0) / 2.0
    card = fid.get_activations(x01)
    cpu = pool3_features(inception_from_jax(get_params_cached()[0]),
                         x01.cpu()).numpy()
    err = np.abs(card - cpu)
    if not (err <= TOL_POOL3["atol"] + TOL_POOL3["rtol"] * np.abs(cpu)).all():
        fail(f"fid: pool3 on the card differs from the CPU by up to "
             f"{err.max():.3e} (tol {TOL_POOL3})")
    say(f"[fid] stats of {STATS_IMAGES} synthetic images in {t_stats:.2f} s "
        f"(pretrained Inception: {fid.inception_is_pretrained()}); self-FID "
        f"{self_fid:.3e} vs tr(sigma) {tr:.3e} (tol {TOL_SELF_FID:.0e} x "
        f"tr); pool3 card vs CPU, 2 images: max abs err {err.max():.3e}")
    return path


def planned_paths(fl, torch, shapes) -> dict:
    """fused_linear launches by path for one call at each shape, as ``plan``
    sends the port's float32 (N, K) weight."""
    paths = {}
    for _, m, k, n, _, xdt, calls in shapes:
        p = fl.plan(m, n, k, getattr(torch, xdt), torch.float32, True)
        paths[p.path] = paths.get(p.path, 0) + calls
    return paths


# the loss values each experiment's run returns
RUN_LOSSES = {"betavaegan": ("Avg Eec Loss", "Avg Dis Loss"),
              "vae": ("Avg Loss",), "gan": ("Avg Loss G", "Avg Loss E")}


def count_launches(fl, pin, run) -> tuple:
    """``run()`` with every kernel's count set to 0 just before and read
    just after; returns (its result, launches, fused_linear by path,
    seconds). The BatchNorm calls are counted by mode: ``batchnorm`` in
    train mode, ``batchnorm_eval`` in eval mode; every one has to take the
    ring, and the copies the calls made before their passes are kept in
    ``BN_COPIES``."""
    import torch

    from disentangle_mlp_tpu_torch.ops import batchnorm as bno
    from disentangle_mlp_tpu_torch.ops import depthwise_conv as dwc

    fl.launches = pin.launches = bno.launches = dwc.launches = 0
    fl.path_launches.clear()
    bno.path_launches.clear()
    dwc.path_launches.clear()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_linear": fl.launches,
                "per_image_normalize": pin.launches,
                "batchnorm": bno.path_launches["rows"],
                "batchnorm_eval": bno.path_launches["eval"],
                "batchnorm_swish": bno.path_launches["swish"]}
    if bno.launches != launches["batchnorm"] + launches["batchnorm_eval"]:
        fail(f"batchnorm: {bno.launches} launches, by mode "
             f"{dict(bno.path_launches)}")
    if bno.path_launches["ring"] != bno.launches:
        fail(f"batchnorm: {bno.launches} calls, {bno.path_launches['ring']} "
             f"of them through the ring: {dict(bno.path_launches)}")
    BN_COPIES["last"] = bno.path_launches["copies"]
    BN_COPIES["total"] += BN_COPIES["last"]
    if dwc.launches != sum(dwc.path_launches[p] for p in dwc.PATHS):
        fail(f"depthwise_conv: {dwc.launches} launches, by path "
             f"{dict(dwc.path_launches)}")
    DW_LAUNCHES["last"] = dict(dwc.path_launches)
    DW_LAUNCHES["total"] += dwc.launches
    return out, launches, dict(fl.path_launches), wall


def check_launches(fl, torch, label, launches, by_path, shapes, fids,
                   bn: int) -> None:
    """The launches of a run against what its code path makes: the
    fused_linear calls of ``shapes`` (and the FID decode's), by the path
    ``plan`` gives each, per_image_normalize twice for each of the
    ``fids`` FIDs, and ``bn`` train-mode BatchNorm calls (the FIDs' own
    added here)."""
    fids = int(fids)
    if fids:
        shapes = shapes + [FID_DECODE_SHAPE[:-1]
                           + (FID_FUSED_LINEAR_LAUNCHES * fids,)]
    want = {"fused_linear": sum(s[-1] for s in shapes),
            "per_image_normalize": NORM_LAUNCHES_PER_EPOCH * fids,
            "batchnorm": bn + BN_FID_LAUNCHES * fids, "batchnorm_eval": 0,
            "batchnorm_swish": 0}
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want}")
    if DW_LAUNCHES["last"]:
        fail(f"{label}: depthwise_conv launches {DW_LAUNCHES['last']}, "
             f"expected none")
    want_paths = planned_paths(fl, torch, shapes)
    if by_path != want_paths:
        fail(f"{label}: fused_linear launches by path {by_path}, expected "
             f"{want_paths} from plan")


def train(fl, pin, model: str, mode: str, size: int, card: str,
          stats_path: str = "", save: bool = False) -> tuple:
    """Full-width training of ``model`` through the trainer CLI, with FID
    over N_SAMPLES samples when ``stats_path`` is given and the final
    checkpoint saved (and the save timed) with ``save``; returns the kernel
    launches it made, fused_linear's launches by path and, with ``save``,
    the checkpoint's path, a copy of the states it saved and the save's
    seconds."""
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    from disentangle_mlp_tpu_torch.train import loop
    import torch

    steps = size // BATCH
    name = f"smoke_{model}_{mode}"
    argv = ["--model", model, "--name", name,
            "--device", "cuda", "--epochs", "1",
            "--batch_size_train", str(BATCH), "--dtype", "bfloat16",
            "--synthetic_data", "True", "--synthetic_train_size", str(size),
            "--checkpoint_every", "1" if save else "0", "--freeze_mode", mode,
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    if stats_path:
        argv += ["--calc_fid", "True", "--n_samples", str(N_SAMPLES),
                 "--fid_save_samples", "True",
                 "--fid_path_pretrained", stats_path]
    else:
        argv += ["--calc_fid", "False"]
    saved = {}
    checkpointer = loop.AsyncCheckpointer

    class Recording(checkpointer):
        """The run's checkpointer, keeping a copy of what it saves."""

        def save(self, path, epoch, states, rotate_keep=0):
            saved.update(path=path, checkpointer=self, states={
                k: {part: _tree_map(v[part], torch.clone) for part in v}
                for k, v in states.items()})
            super().save(path, epoch, states, rotate_keep)

    loop.AsyncCheckpointer = Recording
    try:
        out, launches, by_path, wall = count_launches(
            fl, pin, lambda: train_main(argv))
    finally:
        loop.AsyncCheckpointer = checkpointer
    metrics = out["step_metrics"]
    values = [out[k] for k in RUN_LOSSES[model]] + list(metrics.values())
    if not all(math.isfinite(v) for v in values):
        fail(f"train {model} {mode}: non-finite loss {out}")
    shapes = [s[:-1] + (s[-1] * steps,) for s in STEP_SHAPES[model]]
    kind = f"betavaegan {mode}" if model == "betavaegan" else model
    check_launches(fl, torch, f"train {model} {mode}", launches, by_path,
                   shapes, bool(stats_path),
                   steps * BN_STEP_LAUNCHES[kind])
    notes = []
    if stats_path:
        fid = out["FID"]
        if not (isinstance(fid, float) and math.isfinite(fid)):
            fail(f"train {model} {mode}: FID {fid!r} is not a finite float")
        # the β-VAE-GAN scores per-epoch FID into fid_results/recons, as
        # the reference does; the other two into fid_results/samples
        kind = "recons" if model == "betavaegan" else "samples"
        pngs = glob.glob(os.path.join(RUN_DIR, name, "fid_results", kind,
                                      "sample_*_0.png"))
        if len(pngs) != N_SAMPLES:
            fail(f"train {model} {mode}: {len(pngs)} sample PNGs, expected "
                 f"{N_SAMPLES}")
        notes.append(f"FID {fid:.4f} over {N_SAMPLES} samples, {len(pngs)} "
                     f"sample PNGs")
    else:
        notes.append("no FID")
    if save:
        if not saved:
            fail(f"train {model} {mode}: no checkpoint was saved")
        last = saved["checkpointer"].last
        if last.get("path") != saved["path"]:
            fail(f"train {model} {mode}: the checkpoint did not land")
        saved.update(bytes=last["bytes"], blocked=last["blocked_s"],
                     seconds=last["landed_s"])
        notes.append(f"checkpoint {saved['bytes'] / 1e9:.3f} GB: save() "
                     f"blocked {saved['blocked'] * 1e3:.1f} ms, the file "
                     f"landed {saved['seconds']:.2f} s after it")
    rate = out["images_per_sec"]
    say(f"[train] {model} {mode}: {steps} steps at batch {BATCH}, bf16, full "
        f"width; {rate:.1f} img/s, {BATCH / rate * 1e3:.2f} ms/step "
        f"(steps 2..{steps}, FID excluded); wall {wall:.1f} s incl. init; "
        f"{'; '.join(notes)}; launches {json.dumps(launches)}, fused_linear "
        f"by path {json.dumps(by_path)}; last step {json.dumps(metrics)}; "
        f"card {card}")
    return launches, by_path, saved


def nvae_step_launches() -> dict:
    """Kernel launches of one NVAE training step, from the plain
    reference's tables: each BatchNorm call once forward and once
    backward, the Swish ones also under ``batchnorm_swish``, and each
    squeeze-excitation's two ``fused_linear`` calls (forward; their
    backward is not the kernel)."""
    ref, c = nvae_reference()
    bn = ref.batchnorm_calls(c)
    return {"fused_linear": len(ref.fused_linear_launches(c)),
            "per_image_normalize": 0, "batchnorm": 2 * len(bn),
            "batchnorm_eval": 0,
            "batchnorm_swish": 2 * sum(a == "swish" for _, _, a in bn)}


def train_nvae(fl, pin, card: str) -> tuple:
    """NVAE at its published widths and batch (h100_bench/configs/
    nvae_celeba64.json) through the trainer CLI, ``NVAE_STEPS`` steps
    without FID: losses finite, and the launches equal to the reference's
    tables a step, fused_linear's also by the path ``plan`` gives each.
    Returns the launches and fused_linear's by path."""
    import gc

    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    import torch

    _, c = nvae_reference()
    batch = c["batch_size_train"]
    argv = ["--model", "nvae", "--name", "smoke_nvae", "--device", "cuda",
            "--epochs", "1", "--batch_size_train", str(batch),
            "--dtype", c["dtype"], "--lr", str(c["lr"]),
            "--synthetic_data", "True",
            "--synthetic_train_size", str(NVAE_STEPS * batch),
            "--checkpoint_every", "0", "--calc_fid", "False",
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    out, launches, by_path, wall = count_launches(
        fl, pin, lambda: train_main(argv))
    values = [out[k] for k in ("Avg Loss", "Avg Recon Loss", "Avg KL")] + \
        list(out["step_metrics"].values())
    if not all(math.isfinite(v) for v in values):
        fail(f"train nvae: non-finite loss {out}")
    want = {k: NVAE_STEPS * v for k, v in nvae_step_launches().items()}
    if launches != want:
        fail(f"train nvae: kernel launches {launches}, expected {want}")
    want_dw = {k: NVAE_STEPS * v for k, v in NVAE_DW_LAUNCHES.items()}
    if DW_LAUNCHES["last"] != want_dw:
        fail(f"train nvae: depthwise_conv launches {DW_LAUNCHES['last']}, "
             f"expected {want_dw}")
    copies = BN_COPIES["last"]
    if copies != NVAE_STEPS * NVAE_BN_COPIES:
        fail(f"train nvae: {copies} copies before the BatchNorm passes, "
             f"expected {NVAE_STEPS} × {NVAE_BN_COPIES}")
    shapes = [s[:-1] + (s[-1] * NVAE_STEPS,) for s in nvae_linear_shapes()]
    want_paths = planned_paths(fl, torch, shapes)
    if by_path != want_paths:
        fail(f"train nvae: fused_linear launches by path {by_path}, "
             f"expected {want_paths} from plan")
    rate = out["images_per_sec"]
    reserved = torch.cuda.max_memory_reserved() / 1e9
    say(f"[train] nvae: {NVAE_STEPS} steps at batch {batch}, "
        f"{c['dtype']}, published widths; {rate:.1f} img/s, "
        f"{batch / rate * 1e3:.2f} ms/step (steps 2..{NVAE_STEPS}); wall "
        f"{wall:.1f} s incl. init; no FID; {held / 1e9:.2f} GB held before "
        f"it, peak {reserved:.2f} GB reserved (cuDNN's depthwise "
        f"convolutions: {NVAE_CUDNN_RESERVED_GB:.2f}); launches "
        f"{json.dumps(launches)} ({NVAE_STEPS} × the reference's step, "
        f"every BatchNorm call through the ring; {copies} copies before "
        f"them), depthwise_conv {json.dumps(DW_LAUNCHES['last'])} "
        f"({NVAE_STEPS} × {NVAE_DW_LAUNCHES}), fused_linear by path "
        f"{json.dumps(by_path)}; "
        f"last step {json.dumps(out['step_metrics'])}; card {card}")
    if reserved > NVAE_CUDNN_RESERVED_GB + 0.005:
        fail(f"train nvae: {reserved:.2f} GB reserved at its peak, more than "
             f"the {NVAE_CUDNN_RESERVED_GB:.2f} GB through cuDNN")
    return launches, by_path


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def evaluate(fl, pin, saved: dict, stats_path: str, card: str) -> tuple:
    """The evaluation CLI over the 'intent' run's checkpoint: FID over
    N_SAMPLES samples, the reconstruction, originals and sample grids, the
    sweep's launches; then the checkpoint restored into a new experiment
    must give back the states the run saved, bit for bit."""
    from disentangle_mlp_tpu_torch.cli.evaluate import main as evaluate_main
    from disentangle_mlp_tpu_torch.cli.train import parse
    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.train import loop
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    import torch

    name = "smoke_eval"
    argv = ["--model", "betavaegan", "--name", name, "--device", "cuda",
            "--freeze_mode", "intent", "--dtype", "bfloat16",
            "--synthetic_data", "True", "--load_path", saved["path"],
            "--calc_fid", "True", "--n_samples", str(N_SAMPLES),
            "--fid_path_pretrained", stats_path, "--test_recons", "True",
            "--test_samples", "True",
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    out, launches, by_path, wall = count_launches(
        fl, pin, lambda: evaluate_main(argv))
    check_launches(fl, torch, "eval", launches, by_path, SWEEP_SHAPES[1:],
                   True, BN_SWEEP_LAUNCHES - BN_FID_LAUNCHES)
    (rec,) = out["sweep"]
    fid, epoch = rec["FID"], rec["Epoch"]
    if not (isinstance(fid, float) and math.isfinite(fid)):
        fail(f"eval: FID {fid!r} is not a finite float")
    results = os.path.join(RUN_DIR, name, "test_results")
    grids = [os.path.join(results, d, f"{stem}_{epoch}.png")
             for d, stem in (("recons", "recon"), ("originals", "original"),
                             ("samples", "sample"))]
    missing = [g for g in grids if not os.path.isfile(g)]
    if missing:
        fail(f"eval: grids missing: {missing}")
    _, device, kwargs = parse("smoke", argv)  # the sweep's own config
    exp = VAEGANExperiment(Config(**kwargs), device)
    t0 = time.perf_counter()
    loop._restore(exp, saved["path"])
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    restored = dict(_tree_leaves(exp.states()))
    want = dict(_tree_leaves(saved["states"]))
    if restored.keys() != want.keys():
        fail("eval: the restored states have another structure than the "
             "saved ones")
    differ = [k for k, v in want.items()
              if not (restored[k].dtype == v.dtype
                      and torch.equal(restored[k], v))]
    if differ:
        fail(f"eval: {len(differ)} restored leaves differ from the saved "
             f"ones, e.g. {differ[:3]}")
    say(f"[eval] betavaegan intent checkpoint of epoch {epoch}: FID "
        f"{fid:.4f} over {N_SAMPLES} samples; recon, originals and sample "
        f"grids written; wall {wall:.1f} s incl. init and load; restored "
        f"{len(want)} leaves equal to the saved ones bit for bit (load "
        f"{t_load:.2f} s); launches {json.dumps(launches)}, fused_linear by "
        f"path {json.dumps(by_path)}; card {card}")
    return launches, by_path


def fid_split(stats_path: str, card: str, dataset: str = "celebA") -> tuple:
    """The per-epoch FID phase once more, each part timed on its own
    (host clock around work ended by a synchronize), and the decoder's
    BatchNorm running statistics checked unchanged by the sampling
    decode: the β-VAE-GAN's decoder at 64×64, or the birds generator at
    128×128 (``dataset="birds"``)."""
    import torch

    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.eval import fid
    from disentangle_mlp_tpu_torch.eval.samples import (_sample_latents,
                                                        write_sample_files)
    from disentangle_mlp_tpu_torch.models.layers import BatchNorm
    from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment

    if dataset == "birds":  # the JAX defaults, bf16
        cfg = Config(name="smoke_fid_birds", dataset="birds",
                     img_size=BIRDS_IMG)
        exp = FamilyExperiment(cfg, "cuda")
        decoder, shape = exp.vae.generator, BIRDS_NORM_SHAPE
    else:
        cfg = Config(name="smoke_fid")  # full default width, bf16
        exp = VAEGANExperiment(cfg, "cuda")
        decoder, shape = exp.vae.decoder, NORM_SHAPE
    bns = [m for m in decoder.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    mu2, s2 = fid.load_stats_npz(stats_path)
    out_dir = os.path.join(RUN_DIR, f"fid_split_{dataset}")
    os.makedirs(out_dir, exist_ok=True)
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return res

    z = _sample_latents(cfg.seed, N_SAMPLES, cfg.n_hidden, "cuda")
    out = timed("decode", lambda: exp.decode(z))
    if not all(torch.equal(m.running_mean, a) and torch.equal(m.running_var, b)
               for m, (a, b) in zip(bns, before)):
        fail("fid: the sampling decode changed the decoder's BatchNorm "
             "running statistics")
    if out.shape != shape or out.dtype != torch.bfloat16:
        fail(f"fid: decode gave {out.dtype} {tuple(out.shape)}")
    imgs = timed("normalize", lambda: fid.per_image_normalize(out))
    acts = timed("pool3", lambda: fid.get_activations(imgs))
    u8 = timed("quantize_and_pull",
               lambda: fid.normalized_u8(out).cpu().numpy())
    score = timed("frechet", lambda: fid.frechet_from_acts(acts, mu2, s2))
    timed("png_writes", lambda: write_sample_files(u8, 0, out_dir))
    if not math.isfinite(score):
        fail(f"fid: score {score} is not finite")
    ms["total"] = sum(ms.values())
    say(f"[fid] phase split{' birds' if dataset == 'birds' else ''} over "
        f"{N_SAMPLES} samples {shape[1]}x{shape[2]}, ms (BatchNorm running "
        f"statistics unchanged; FID {score:.4f}; card {card}): "
        f"{json.dumps(ms)}")
    return out_dir, u8


def _u8_diff(got, want) -> dict:
    import numpy as np

    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"max": int(d.max()), "mean": float(d.mean()),
            "exact": float((d == 0).mean())}


def data_decoder(card: str) -> dict:
    """The JPEG decoder of the card path: nvJPEG, built and opened."""
    from disentangle_mlp_tpu_torch.data import native

    info = native.decoder_info("cuda")
    if info["decoder"] != "nvjpeg":
        fail(f"data: the card path decodes with {info}, not nvJPEG")
    say(f"[data] decoder nvJPEG {info['version']}, {info['backend']} "
        f"(JPEGs decoded on the card; the host path is libjpeg); card {card}")
    return info


def data_fixture(card: str) -> dict:
    """The committed fixture on the card against the JAX package's output
    for the same files: PIL's full-resolution decode of four, and
    load_batch_u8 at 64×64 of all 16."""
    import numpy as np
    import torch

    from disentangle_mlp_tpu_torch.data import native

    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        names, u8 = list(f["names"]), f["u8_64"]
        full_names, full = list(f["full_names"]), f["full"]
    jpeg_dir = os.path.join(FIXTURE, "jpeg", "c0")
    paths = [os.path.join(jpeg_dir, n) for n in names]
    full_paths = [os.path.join(jpeg_dir, n) for n in full_names]
    single0 = native.card_single
    dec = native.decode(native.read_files(full_paths), full_paths, "cuda")
    got_full = np.stack([d.cpu().numpy() for d in dec])
    if got_full.shape != full.shape:
        fail(f"data fixture: full-resolution decode {got_full.shape}, "
             f"expected {full.shape}")
    d_full = _u8_diff(got_full, full)
    per_file = {n: _u8_diff(g, w)["max"]
                for n, g, w in zip(full_names, got_full, full)}
    got = native.decode_resize(native.read_files(paths), paths, 64, "cuda")
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    if got.shape != u8.shape:
        fail(f"data fixture: 64x64 batch {got.shape}, expected {u8.shape}")
    d64 = _u8_diff(got, u8)
    worst = max(zip(names, got, u8), key=lambda t: _u8_diff(t[1], t[2])["max"])
    say(f"[data] fixture on the card vs the JAX package's output: full "
        f"resolution ({len(full_names)} files vs PIL) max |d| {d_full['max']}"
        f", mean {d_full['mean']:.4f}, exact {d_full['exact']:.4f} (max by "
        f"file {json.dumps(per_file)}); 64x64 ({len(names)} files vs "
        f"load_batch_u8) max |d| {d64['max']}, mean {d64['mean']:.4f}, exact "
        f"{d64['exact']:.4f} (tol mean {TOL_FIXTURE['mean']}, max "
        f"{TOL_FIXTURE['max']}, full resolution max {TOL_FIXTURE_FULL}; "
        f"worst file {worst[0]}); "
        f"{native.card_single - single0} of {len(names) + len(full_names)} "
        f"decodes one at a time; card {card}")
    if d64["mean"] > TOL_FIXTURE["mean"] or d64["max"] > TOL_FIXTURE["max"]:
        fail(f"data fixture: 64x64 mean |d| {d64['mean']:.4f} or max "
             f"{d64['max']} above {TOL_FIXTURE}")
    if d_full["max"] > TOL_FIXTURE_FULL:
        fail(f"data fixture: full-resolution max |d| {d_full['max']} above "
             f"{TOL_FIXTURE_FULL}: more than the IDCT's rounding")
    # a damaged file among good ones raises on the card, naming it
    data = native.read_files(paths[:3])
    damaged = {"cut.jpg": data[1][:len(data[1]) // 2],
               "headless.jpg": b"\xff\xd8" + bytes(range(255)) * 16
               + b"\xff\xd9"}
    for bad, content in damaged.items():
        try:
            native.decode([data[0], content, data[2]],
                          [paths[0], bad, paths[2]], "cuda")
            torch.cuda.synchronize()
        except ValueError as e:
            if bad not in str(e):
                fail(f"data fixture: the error for {bad} does not name it: "
                     f"{e}")
            say(f"[data] damaged file on the card raises: {e}")
        else:
            fail(f"data fixture: {bad} decoded on the card without an error")
    return {"full": d_full, "u8_64": d64}


def data_color(card: str) -> dict:
    """The colour fixture on the card against the host decode (libjpeg;
    PIL's for CMYK and YCCK) at full resolution: a CMYK, a YCCK, a 4:4:0
    and a 4:1:1 file."""
    import numpy as np
    import torch

    from disentangle_mlp_tpu_torch.data import native

    with np.load(os.path.join(FIXTURE, "expected_color.npz")) as f:
        cnames, cfull = list(f["names"]), f["full"]
    cpaths = [os.path.join(FIXTURE, "jpeg_color", n) for n in cnames]
    single0 = native.card_single
    cdec = native.decode(native.read_files(cpaths), cpaths, "cuda")
    torch.cuda.synchronize()
    color = {}
    for n, g, want in zip(cnames, cdec, cfull):
        if tuple(g.shape) != want.shape:
            fail(f"data colour: {n} decoded to {tuple(g.shape)} on the "
                 f"card, expected {want.shape}")
        color[n] = _u8_diff(g.cpu().numpy(), want)
    say(f"[data] colour fixture on the card vs the host decode (libjpeg; "
        f"PIL's for CMYK and YCCK), full resolution: "
        f"{json.dumps(color)} (tol max {TOL_FIXTURE_FULL}); "
        f"{native.card_single - single0} of {len(cnames)} decodes one at a "
        f"time; card {card}")
    bad = {n: d["max"] for n, d in color.items()
           if d["max"] > TOL_FIXTURE_FULL}
    if bad:
        fail(f"data colour: files above the full-resolution bar: "
             f"{bad}")
    return color


def make_tree(root: str) -> tuple:
    """A class-subdirectory tree of TREE_IMAGES copies of the fixture JPEGs
    (each copy a file of its own, so each costs a decode) and a flat
    directory of FID_DIR_IMAGES of them."""
    src_dir = os.path.join(FIXTURE, "jpeg", "c0")
    files = sorted(glob.glob(os.path.join(src_dir, "*.jpg")))
    tree = os.path.join(root, "tree")
    fid_dir = os.path.join(root, "fid_dir")
    for c in range(TREE_CLASSES):
        os.makedirs(os.path.join(tree, f"c{c}"), exist_ok=True)
    os.makedirs(fid_dir, exist_ok=True)
    for i in range(TREE_IMAGES):
        shutil.copyfile(files[i % len(files)],
                        os.path.join(tree, f"c{i % TREE_CLASSES}",
                                     f"{i:05d}.jpg"))
        if i < FID_DIR_IMAGES:
            shutil.copyfile(files[i % len(files)],
                            os.path.join(fid_dir, f"{i:05d}.jpg"))
    return tree, fid_dir


def data_tree(tree: str, card: str) -> dict:
    """Two epochs of the tree through get_data_loader on the card: epoch 1
    decodes every image into the device cache, epoch 2 decodes none."""
    import numpy as np
    import torch

    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.data import native
    from disentangle_mlp_tpu_torch.data.pipeline import get_data_loader

    cfg = Config(name="smoke_tree", image_root_train=tree,
                 batch_size_train=BATCH, synthetic_data=False,
                 save_path=os.path.join(RUN_DIR, "%"),
                 log_path=os.path.join(RUN_DIR, "%", "log")
                 ).finalize(make_dirs=False)
    train, _, _ = get_data_loader(cfg, "cuda")
    src = train.source
    if src._cache is None or src._cache.device.type != "cuda":
        fail("data tree: the train stream has no decode cache on the card")
    rates, decoded = [], []
    for epoch in range(2):
        before, card0 = src.decoded, native.card_decoded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for x, y in train:
            if (x.shape != (BATCH, 64, 64, 3) or x.dtype != torch.float32
                    or x.device.type != "cuda"):
                fail(f"data tree: batch {x.dtype} {tuple(x.shape)} on "
                     f"{x.device}")
            n += x.shape[0]
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        decoded.append((src.decoded - before, native.card_decoded - card0))
        if n != TREE_IMAGES:
            fail(f"data tree: epoch {epoch + 1} fed {n} images")
    lo, hi = float(x.min()), float(x.max())
    if not (-1.0 <= lo <= hi <= 1.0):
        fail(f"data tree: batch values in [{lo}, {hi}], not [-1, 1]")
    if decoded[0] != (TREE_IMAGES, TREE_IMAGES) or not src._cached.all():
        fail(f"data tree: epoch 1 decoded {decoded[0]} (source, nvJPEG), "
             f"cache filled {int(src._cached.sum())} of {TREE_IMAGES}")
    if decoded[1] != (0, 0):
        fail(f"data tree: epoch 2 decoded {decoded[1]}, expected none")
    # one batch's share of each part (host clock, ended by a synchronize)
    paths = [p for p, _ in src.samples[:BATCH]]
    ms = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms[key] = (time.perf_counter() - t0) * 1e3
        return res

    # the files read on one thread (as the feed does) and on four, in turns
    with ThreadPoolExecutor(4) as pool:
        for key, reader in (
                ("read_files", native.read_files),
                ("read_files_4_threads", lambda ps: list(pool.map(
                    native._read, ps))),
                ("read_files_4_threads_2", lambda ps: list(pool.map(
                    native._read, ps))),
                ("read_files_2", native.read_files)):
            datas = timed(key, lambda: reader(paths))
    imgs = timed("nvjpeg_decode", lambda: native.decode(datas, paths, "cuda"))
    timed("resize", lambda: native.resize_u8(imgs, 64))
    # device time of one batch, uncached (decode and resize) and cached
    # (gather and normalize): the feed's share of a step's device time
    idx = np.arange(BATCH)
    dev = {"uncached": device_ms(lambda: native.decode_resize(
               datas, paths, 64, "cuda")),
           "cached": device_ms(lambda: train._normalize(
               src.load_batch_u8(idx)[0]))}
    say(f"[data] tree of {TREE_IMAGES} JPEGs (178x218) through "
        f"get_data_loader on the card, batch {BATCH}: epoch 1 (decode, "
        f"resize, fill the cache) {rates[0]:.1f} img/s, {decoded[0][0]} "
        f"decoded; epoch 2 (cached) {rates[1]:.1f} img/s, {decoded[1][0]} "
        f"decoded; cache {src._cache.numel() / 1e6:.1f} MB on the card; one "
        f"batch's parts, ms: {json.dumps(ms)}; device ms of one batch "
        f"(profiler): {json.dumps(dev)}; card {card}")
    del train, src
    return {"epoch1_img_per_s": rates[0], "epoch2_img_per_s": rates[1],
            "batch_ms": ms, "batch_device_ms": dev}


def device_ms(fn) -> float:
    """Device time of ``fn()``: the sum of the kernels' and copies' self
    time in a torch.profiler trace."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) / 1e3


def train_folder(fl, pin, tree: str, fid_dir: str, card: str) -> tuple:
    """The β-VAE-GAN through the trainer CLI on the JPEG tree, full default
    width, 'observed', FOLDER_EPOCHS epochs, with FID against the directory
    of images ``fid_dir`` (without FID when it is empty, which shows the
    feed's rates without the FID's host work overlapping epoch 2); returns
    the launches, fused_linear by path and the rates."""
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    from disentangle_mlp_tpu_torch.data import native
    from disentangle_mlp_tpu_torch.train import loop
    import torch

    name = "smoke_folder" if fid_dir else "smoke_folder_nofid"
    argv = ["--model", "betavaegan", "--name", name, "--device", "cuda",
            "--epochs", str(FOLDER_EPOCHS), "--batch_size_train", str(BATCH),
            "--dtype", "bfloat16", "--freeze_mode", "observed",
            "--image_root_train", tree, "--synthetic_data", "False",
            "--checkpoint_every", "0",
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    if fid_dir:
        argv += ["--calc_fid", "True", "--n_samples", str(N_SAMPLES),
                 "--fid_save_samples", "True", "--fid_path_pretrained",
                 fid_dir]
    else:
        argv += ["--calc_fid", "False"]
    epochs = []
    train_epoch = loop._Run.train_epoch

    def timed_epoch(run, *a, **k):
        torch.cuda.synchronize()
        t0, dec0 = time.perf_counter(), run.train_loader.source.decoded
        res = train_epoch(run, *a, **k)
        torch.cuda.synchronize()
        steps = len(run.train_loader)
        epochs.append({"img_per_s": steps * BATCH / (time.perf_counter() - t0),
                       "steps": steps,
                       "decoded": run.train_loader.source.decoded - dec0})
        return res

    loop._Run.train_epoch = timed_epoch
    card0 = native.card_decoded
    try:
        out, launches, by_path, wall = count_launches(
            fl, pin, lambda: train_main(argv))
    finally:
        loop._Run.train_epoch = train_epoch
    logs = glob.glob(os.path.join(RUN_DIR, name, "log", "log_*.json"))
    if len(logs) != 1:
        fail(f"train folder: {len(logs)} log files")
    with open(logs[0]) as f:
        records = json.load(f)["output"]
    fids = [r["FID"] for r in records] if fid_dir else []
    losses = [r[k] for r in records for k in ("Avg Eec Loss", "Avg Dnc Loss",
                                              "Avg Dis Loss")]
    losses += list(out["step_metrics"].values())
    if len(records) != FOLDER_EPOCHS or not all(
            isinstance(v, float) and math.isfinite(v) for v in fids + losses):
        fail(f"train folder: records {records}, last step "
             f"{out['step_metrics']}: losses and FIDs must be finite floats")
    steps = sum(e["steps"] for e in epochs)
    if len(epochs) != FOLDER_EPOCHS or steps != FOLDER_EPOCHS * TREE_IMAGES \
            // BATCH:
        fail(f"train folder: epochs {epochs}")
    if sum(e["decoded"] for e in epochs[1:]):
        fail(f"train folder: epochs after the first decoded images: {epochs}")
    # the tree once (loop and warm-up share the work), the FID directory
    # every epoch
    card_decoded = native.card_decoded - card0
    want = TREE_IMAGES + (FOLDER_EPOCHS * FID_DIR_IMAGES if fid_dir else 0)
    if card_decoded != want:
        fail(f"train folder: nvJPEG decoded {card_decoded} images, expected "
             f"{want}")
    shapes = [sh[:-1] + (sh[-1] * steps,) for sh in FUSED_LINEAR_SHAPES]
    check_launches(fl, torch, f"train {name}", launches, by_path, shapes,
                   FOLDER_EPOCHS if fid_dir else 0,
                   steps * BN_STEP_LAUNCHES["betavaegan observed"])
    fid_note = (f"FID per epoch against a directory of {FID_DIR_IMAGES} "
                f"JPEGs {[round(v, 4) for v in fids]}" if fid_dir
                else "no FID")
    say(f"[train] betavaegan folder{'' if fid_dir else ', no FID'}: "
        f"{FOLDER_EPOCHS} epochs x "
        f"{steps // FOLDER_EPOCHS} steps at batch {BATCH}, bf16, full width, "
        f"observed, on {TREE_IMAGES} JPEGs; img/s per epoch (wall, all "
        f"steps) {[round(e['img_per_s'], 1) for e in epochs]}, decoded per "
        f"epoch in the loop {[e['decoded'] for e in epochs]} (nvJPEG "
        f"{card_decoded} in all: the tree once, the FID directory each "
        f"epoch); meter {out['images_per_sec']:.1f} img/s; {fid_note}; "
        f"losses {json.dumps(records[-1])}; wall {wall:.1f} s incl. init; "
        f"launches {json.dumps(launches)}, fused_linear by path "
        f"{json.dumps(by_path)}; card {card}")
    return launches, by_path, [e["img_per_s"] for e in epochs]


def write_mnist(root: str) -> str:
    """An MNIST idx pair of MNIST_IMAGES seeded 28×28 images (smooth blobs
    on black, like digits' strokes) and labels under ``root``."""
    import struct

    import numpy as np

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:28, 0:28]
    c = rng.uniform(6, 22, (MNIST_IMAGES, 3, 2))
    r = rng.uniform(2, 5, (MNIST_IMAGES, 3))
    d2 = ((yy[None, None] - c[..., 0, None, None]) ** 2
          + (xx[None, None] - c[..., 1, None, None]) ** 2)
    imgs = (255 * np.exp(-d2 / (2 * r[..., None, None] ** 2)).max(1))
    imgs = imgs.clip(0, 255).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">HBB3I", 0, 8, 3, MNIST_IMAGES, 28, 28)
                + imgs.tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">HBBI", 0, 8, 1, MNIST_IMAGES)
                + rng.integers(0, 10, MNIST_IMAGES, dtype=np.uint8).tobytes())
    return root


def train_family(fl, pin, label: str, flags: list, epochs: int,
                 fid: bool, save: bool, card: str) -> tuple:
    """A family through the trainer CLI at full default width (batch 256,
    the JAX defaults), ``epochs`` epochs with ``flags``; every loss finite,
    each epoch's FID a finite float (``fid``) or 'N/A', the last checkpoint
    saved (``save``); launches 0 fused_linear and 2 per_image_normalize per
    FID epoch. Returns the launches, fused_linear by path and img/s per
    epoch."""
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    from disentangle_mlp_tpu_torch.train import loop
    import torch

    name = f"smoke_{label.replace(' ', '_')}"
    argv = ["--name", name, "--device", "cuda", "--epochs", str(epochs),
            "--batch_size_train", str(BATCH), "--dtype", "bfloat16",
            "--checkpoint_every", "1" if save else "0",
            "--keep_checkpoints", "1",
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log"), *flags]
    epochs_seen = []
    train_epoch = loop._Run.train_epoch

    def timed_epoch(run, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_epoch(run, *a, **k)
        torch.cuda.synchronize()
        steps = len(run.train_loader)
        epochs_seen.append({"steps": steps, "img_per_s": steps * BATCH
                            / (time.perf_counter() - t0)})
        return res

    loop._Run.train_epoch = timed_epoch
    try:
        out, launches, by_path, wall = count_launches(
            fl, pin, lambda: train_main(argv))
    finally:
        loop._Run.train_epoch = train_epoch
    logs = glob.glob(os.path.join(RUN_DIR, name, "log", "log_*.json"))
    if len(logs) != 1:
        fail(f"train {label}: {len(logs)} log files")
    with open(logs[0]) as f:
        records = json.load(f)["output"]
    losses = [r[k] for r in records for k in ("Avg Loss", "Avg Recon Loss")]
    losses += list(out["step_metrics"].values())
    fids = [r["FID"] for r in records]
    fids_ok = all(isinstance(v, float) and math.isfinite(v) for v in fids) \
        if fid else fids == ["N/A"] * epochs
    if (len(records) != epochs or not fids_ok or not all(
            isinstance(v, float) and math.isfinite(v) for v in losses)):
        fail(f"train {label}: records {records}, last step "
             f"{out['step_metrics']}: losses must be finite floats and FIDs "
             f"{'finite floats' if fid else 'N/A'}")
    want = {"fused_linear": 0,
            "per_image_normalize": NORM_LAUNCHES_PER_EPOCH * epochs * fid,
            "batchnorm": 0, "batchnorm_eval": 0, "batchnorm_swish": 0}
    if launches != want or by_path:
        fail(f"train {label}: kernel launches {launches} by path {by_path}, "
             f"expected {want}")
    notes = [f"FID per epoch {fids}"]
    if fid:
        pngs = glob.glob(os.path.join(RUN_DIR, name, "fid_results", "samples",
                                      f"sample_*_{epochs - 1}.png"))
        if len(pngs) != N_SAMPLES:
            fail(f"train {label}: {len(pngs)} sample PNGs of the last epoch, "
                 f"expected {N_SAMPLES}")
        notes.append(f"{len(pngs)} sample PNGs an epoch")
    if save:
        ckpt = os.path.join(RUN_DIR, name, "models", f"model_{epochs}")
        if not os.path.isfile(ckpt):
            fail(f"train {label}: no checkpoint {ckpt}")
        notes.append(f"checkpoint {os.path.getsize(ckpt) / 1e9:.3f} GB")
    rates = [e["img_per_s"] for e in epochs_seen]
    steps = [e["steps"] for e in epochs_seen]
    say(f"[train] {label}: {epochs} epochs x {steps[0]} steps at batch "
        f"{BATCH}, full width; img/s per epoch (wall, all steps) "
        f"{[round(v, 1) for v in rates]}, meter {out['images_per_sec']:.1f} "
        f"img/s; losses per epoch (Avg Loss, Avg Recon Loss) "
        f"{[(round(r['Avg Loss'], 4), round(r['Avg Recon Loss'], 4)) for r in records]}"
        f"; {'; '.join(notes)}; wall {wall:.1f} s incl. init; launches "
        f"{json.dumps(launches)}; last step {json.dumps(out['step_metrics'])}"
        f"; card {card}")
    return launches, by_path, rates


def fid_dir_stats(out_dir: str, u8, stats_path: str, card: str) -> None:
    """statistics_from_dir over the sample PNGs fid_split wrote against
    the statistics of the same uint8 arrays in memory, pool3 in the same
    batches (the directory's sorted order); then get_fid(dir, npz)."""
    import numpy as np
    import torch

    from disentangle_mlp_tpu_torch.eval import fid

    files = sorted(glob.glob(os.path.join(out_dir, "*.png")))
    if len(files) != N_SAMPLES:
        fail(f"fid dir: {len(files)} PNG files, expected {N_SAMPLES}")
    order = [int(os.path.basename(f).split("_")[1]) for f in files]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, sigma = fid.statistics_from_dir(out_dir, device="cuda")
    t_dir = time.perf_counter() - t0
    x01 = torch.from_numpy(u8[order]).cuda().float() / 255.0
    m2, s2 = fid.activation_statistics(fid.get_activations(x01))
    d_mu = float(np.abs(mu - m2).max() / np.abs(m2).max())
    d_sigma = float(np.abs(sigma - s2).max() / np.abs(s2).max())
    score = fid.get_fid(out_dir, stats_path, device="cuda")
    say(f"[fid] dir: statistics of {len(files)} sample PNGs in {t_dir:.2f} s "
        f"vs the same uint8 arrays in memory: mu rel {d_mu:.3e}, sigma rel "
        f"{d_sigma:.3e} (tol {TOL_DIR_STATS:.0e}); get_fid(dir, npz) "
        f"{score:.4f}; card {card}")
    if d_mu > TOL_DIR_STATS or d_sigma > TOL_DIR_STATS:
        fail(f"fid dir: statistics differ from the in-memory ones: mu "
             f"{d_mu:.3e}, sigma {d_sigma:.3e}")
    if not math.isfinite(score):
        fail(f"fid dir: get_fid {score} is not finite")


# the β search, the reproduction and the checkpoint conversion (phase 12):
# two β evaluations of BO_EPOCHS epoch of BO_STEPS steps each; the
# reproduction's 2 epochs of 2 steps, statistics of up to 2048 images and
# calibration over up to 1024; the converted checkpoint of a reference
# .tar at epoch CONVERT_EPOCH resumed for one epoch of 2 steps
BO_ITERATIONS, BO_EPOCHS, BO_STEPS = 2, 1, 2
BO_SEEDS = 5  # the reference's observations the search starts from
# the GP computed here by np.linalg.solve against the CLI's Cholesky
# posterior: float64 on a 5×5 Gram whose condition number is ~1e2
TOL_BO = 1e-9
REPRO_EPOCHS, REPRO_STEPS = 2, 2
REPRO_STATS, REPRO_CALIB = 2048, 1024
CONVERT_EPOCH, RESUME_STEPS = 3, 2


def _run_paths(name: str) -> list:
    """A run's name, its tree under RUN_DIR and the batch."""
    return ["--name", name, "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log"),
            "--batch_size_train", str(BATCH)]


def gp_posterior(betas, fids, grid, ell=30.0, sigma_f=50.0, xi=0.01,
                 jitter=1e-9):
    """The reference's GP (final_bo.py:24-57, with the CLI's mean shift and
    jitter) and EI for minimization, written out here: posterior mean,
    standard deviation and EI on ``grid``."""
    import numpy as np

    def k(a, b):
        return sigma_f ** 2 * np.exp(-(a[:, None] - b[None, :]) ** 2
                                     / (2.0 * ell ** 2))

    x, y = np.asarray(betas, np.float64), np.asarray(fids, np.float64)
    gram = k(x, x) + jitter * np.eye(x.size)
    ks = k(grid, x)
    mean = y.mean() + ks @ np.linalg.solve(gram, y - y.mean())
    var = sigma_f ** 2 - np.sum(ks * np.linalg.solve(gram, ks.T).T, axis=1)
    std = np.sqrt(np.clip(var, 0.0, None))
    imp = y.min() - mean - xi
    z = np.where(std > 0, imp / np.where(std > 0, std, 1.0), 0.0)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    ei = np.where(std > 0, np.clip(imp * cdf + std * pdf, 0.0, None), 0.0)
    return mean, std, ei


def bo_posterior(card: str) -> None:
    """``cli.bo --posterior_only True`` against the GP computed here from
    the reference's observations."""
    import numpy as np

    from disentangle_mlp_tpu_torch.bo.driver import REFERENCE_OBSERVATIONS
    from disentangle_mlp_tpu_torch.cli import bo

    out = os.path.join(RUN_DIR, "bo_posterior.json")
    t0 = time.perf_counter()
    bo.main(_run_paths("smoke_bo_posterior") + [
        "--posterior_only", "True", "--bo_output", out])
    wall = time.perf_counter() - t0
    with open(out) as f:
        post = json.load(f)
    betas, fids = zip(*REFERENCE_OBSERVATIONS)
    grid = np.arange(1.0, 151.0)
    mean, std, ei = gp_posterior(betas, fids, grid)
    untried = ~np.isin(grid, betas)
    want_beta = float(grid[untried][np.argmax(ei[untried])])
    got = {k: np.asarray(post[k]) for k in
           ("beta", "posterior_mean", "band_low", "band_high",
            "expected_improvement")}
    # the band as a variance: at the observed βs the standard deviation is
    # the square root of rounding-level numbers, which amplifies them
    got_var = ((got["band_high"] - got["band_low"]) / 4.0) ** 2
    errs = {"mean": np.abs(got["posterior_mean"] - mean).max(),
            "band_centre": np.abs((got["band_high"] + got["band_low"]) / 2
                                  - mean).max(),
            "variance": np.abs(got_var - std ** 2).max(),
            "ei": np.abs(got["expected_improvement"] - ei).max()}
    scale = {"mean": 150.0, "band_centre": 150.0, "variance": 50.0 ** 2,
             "ei": max(ei.max(), 1.0)}
    if not np.array_equal(got["beta"], grid) or any(
            errs[k] > TOL_BO * scale[k] for k in errs):
        fail(f"bo posterior: the CLI's posterior differs from the GP "
             f"computed here: max abs errors {errs} (tol {TOL_BO} x {scale})")
    if post["proposed_beta"] != want_beta:
        fail(f"bo posterior: proposed beta {post['proposed_beta']}, the GP "
             f"here proposes {want_beta}")
    if post["observations"] != [list(o) for o in REFERENCE_OBSERVATIONS]:
        fail(f"bo posterior: observations {post['observations']}")
    say(f"[bo] posterior: EI proposes beta {post['proposed_beta']:g} over "
        f"{grid.size} grid points, as the GP computed here; max abs errors "
        f"{json.dumps({k: float(v) for k, v in errs.items()})}; wall "
        f"{wall:.2f} s; card {card}")


def bo_search(fl, pin, stats_path: str, card: str) -> tuple:
    """``cli.bo --posterior_only False``: BO_ITERATIONS β evaluations, each
    a full-width β-VAE-GAN run of BO_EPOCHS epoch of BO_STEPS steps with
    FID over N_SAMPLES samples against phase 4's statistics; then
    ``--bo_parallel 2`` on the one card, which must raise the ValueError
    naming one visible device. Returns the search's launches and
    fused_linear by path."""
    import torch

    from disentangle_mlp_tpu_torch.cli import bo

    name = "smoke_bo"
    report_path = os.path.join(RUN_DIR, "bo_report.json")
    argv = _run_paths(name) + [
        "--device", "cuda", "--posterior_only", "False",
        "--bo_iterations", str(BO_ITERATIONS), "--bo_epochs",
        str(BO_EPOCHS), "--synthetic_data", "True",
        "--synthetic_train_size", str(BO_STEPS * BATCH), "--calc_fid",
        "True", "--n_samples", str(N_SAMPLES), "--fid_path_pretrained",
        stats_path, "--checkpoint_every", "0"]
    _, launches, by_path, wall = count_launches(
        fl, pin, lambda: bo.main(argv + ["--bo_report", report_path]))
    with open(report_path) as f:
        report = json.load(f)
    with open(os.path.join(RUN_DIR, name, "bo_history.json")) as f:
        history = json.load(f)
    cycles = report["cycles"]
    betas = [c["beta"] for c in cycles]
    if not (len(cycles) == BO_ITERATIONS and len(set(betas)) == len(betas)
            and all(1.0 <= b <= 150.0 for b in betas)
            and all(math.isfinite(c["fid"]) for c in cycles)):
        fail(f"bo search: cycles {cycles}")
    if len(history["betas"]) != BO_SEEDS + BO_ITERATIONS or \
            history["betas"][BO_SEEDS:] != betas:
        fail(f"bo search: history {history}")
    if report.get("partial") or not math.isfinite(report["best_fid"]):
        fail(f"bo search: report {report}")
    steps = BO_ITERATIONS * BO_EPOCHS * BO_STEPS
    shapes = [s[:-1] + (s[-1] * steps,) for s in FUSED_LINEAR_SHAPES]
    check_launches(fl, torch, "bo search", launches, by_path, shapes,
                   BO_ITERATIONS * BO_EPOCHS,
                   steps * BN_STEP_LAUNCHES["betavaegan observed"])
    say(f"[bo] search: {BO_ITERATIONS} evaluations of {BO_EPOCHS} epoch x "
        f"{BO_STEPS} steps at batch {BATCH}, bf16, full width, FID over "
        f"{N_SAMPLES} samples; cycles "
        f"{json.dumps([{k: c[k] for k in ('beta', 'fid')} for c in cycles])}"
        f"; wall seconds per evaluation (train + FID, init included) "
        f"{[c['train_fid_wall_s'] for c in cycles]}; search wall "
        f"{wall:.1f} s; history of {len(history['betas'])} observations; "
        f"best beta {report['best_beta']:g} FID {report['best_fid']:.4f}; "
        f"devices {report['devices']}; launches {json.dumps(launches)}, "
        f"fused_linear by path {json.dumps(by_path)}; card {card}")
    # two groups on one card: the ValueError and nothing else
    _, group_launches, _, _ = count_launches(fl, pin, lambda: _bo_groups(
        bo, argv))
    if any(group_launches.values()):
        fail(f"bo groups: launches {group_launches} before the refusal")
    return launches, by_path


def _bo_groups(bo, argv: list) -> None:
    import torch

    n = torch.cuda.device_count()
    try:
        bo.main(argv + ["--bo_parallel", "2"])
    except ValueError as e:
        if f"must be in [1, {n}] (visible devices)" not in str(e):
            fail(f"bo groups: ValueError {e!r} does not name the {n} "
                 f"visible device(s)")
        say(f"[bo] groups: --bo_parallel 2 on {n} visible device raises "
            f"ValueError: {e}")
        return
    fail("bo groups: --bo_parallel 2 on one card did not raise")


def reproduce_run(fl, pin, card: str) -> tuple:
    """``cli.reproduce`` in its synthetic mode at full default width:
    statistics of the train split, the real-vs-real calibration, β=25 for
    REPRO_EPOCHS epochs of REPRO_STEPS steps with FID in the loop against
    those statistics, the report; each part timed. Then
    ``--assets_check``. Returns the launches and fused_linear by path."""
    import contextlib
    import io

    import torch

    from disentangle_mlp_tpu_torch.cli import reproduce as cli
    from disentangle_mlp_tpu_torch.eval import reproduce
    from disentangle_mlp_tpu_torch.train import loop

    name = "smoke_repro"
    stats = os.path.join(RUN_DIR, "repro_stats.npz")
    report_path = os.path.join(RUN_DIR, "repro_report.json")
    argv = _run_paths(name) + [
        "--device", "cuda", "--synthetic_data", "True",
        "--epochs", str(REPRO_EPOCHS), "--synthetic_train_size",
        str(REPRO_STEPS * BATCH), "--stats_images", str(REPRO_STATS),
        "--calib_images", str(REPRO_CALIB), "--stats_out", stats,
        "--report_out", report_path, "--checkpoint_every", "0"]
    parts = {}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[key] = time.perf_counter() - t0
            return out
        return run

    calibration, run_vaegan = reproduce.calibration_fid, loop.run_vaegan
    reproduce.calibration_fid = timed("calibration", calibration)
    loop.run_vaegan = timed("train", run_vaegan)
    try:
        report, launches, by_path, wall = count_launches(
            fl, pin, lambda: cli.main(argv))
    finally:
        reproduce.calibration_fid, loop.run_vaegan = calibration, run_vaegan
    with open(report_path) as f:
        on_disk = json.load(f)
    finite = all(isinstance(report[k], float) and math.isfinite(report[k])
                 for k in ("calibration_fid", "final_fid"))
    curves = all(len(report.get(k, [])) == REPRO_EPOCHS
                 for k in ("fid_curve", "eec_curve"))
    if not (os.path.isfile(stats) and report["stats_path"] == stats
            and finite and curves and on_disk["final_fid"] ==
            report["final_fid"] and report["inception_pretrained"] is False
            and report["within_tolerance"] is False
            and {"curve_ok", "eec_ok", "curve_ratio", "eec_ratio"}
            <= set(report)):
        fail(f"reproduce: report {report}")
    steps = REPRO_EPOCHS * REPRO_STEPS
    shapes = [s[:-1] + (s[-1] * steps,) for s in FUSED_LINEAR_SHAPES]
    check_launches(fl, torch, "reproduce", launches, by_path, shapes,
                   REPRO_EPOCHS, steps * BN_STEP_LAUNCHES["betavaegan observed"])
    parts["statistics and set-up"] = wall - sum(parts.values())
    say(f"[reproduce] synthetic, beta 25 (the CLI's default), "
        f"{REPRO_EPOCHS} epochs x {REPRO_STEPS} steps at batch {BATCH}, "
        f"bf16, full width: statistics of {report['stats_images']} images, "
        f"calibration FID {report['calibration_fid']:.4f} over "
        f"{report['calibration_images']} images, final FID "
        f"{report['final_fid']:.4f}, FID curve {report['fid_curve']}, Eec "
        f"curve {report['eec_curve']}, inception_pretrained "
        f"{report['inception_pretrained']}, within_tolerance "
        f"{report['within_tolerance']}; seconds "
        f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}, wall "
        f"{wall:.1f} s; launches {json.dumps(launches)}, fused_linear by "
        f"path {json.dumps(by_path)}; card {card}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--name", "smoke_assets", "--assets_check"])
    assets = json.loads(buf.getvalue())
    if assets["ready"] is not False:
        fail(f"reproduce: assets reported ready on a machine without them: "
             f"{assets}")
    say(f"[reproduce] assets_check {json.dumps(assets)}")
    return launches, by_path


def fetch_check(mnist_dir: str, card: str) -> None:
    """``cli.fetch_assets`` on this machine, which has no JAX, and nothing
    of it reaches the network: offline with ``--mnist`` into a new
    ``--dest`` it exits 1, plans the FID weights (or reports them present)
    and the four idx files, and writes nothing under ``--dest``; a
    ``file://`` download is installed with its true sha256 prefix and
    refused, leaving nothing behind, with a wrong one; the idx pair phase 6
    wrote, gzipped under the four published names, is installed through
    ``_verify_idx`` (a canonical-shape check refuses these 4096-image
    files), after which ``find_mnist_files`` finds both pairs and the
    command reports them present."""
    import contextlib
    import gzip
    import io
    from pathlib import Path

    import numpy as np

    from disentangle_mlp_tpu_torch.cli import fetch_assets as fa
    from disentangle_mlp_tpu_torch.data.pipeline import (_read_idx,
                                                         find_mnist_files)

    t0 = time.perf_counter()
    root = os.path.join(RUN_DIR, "fetch")
    dest = os.path.join(root, "dest")

    def offline(argv):
        buf = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(buf):
            try:
                fa.main(argv)
            except SystemExit as e:
                code = e.code
        return code, buf.getvalue()

    code, out = offline(["--dest", dest, "--mnist"])
    planned = [ln.split("-> ", 1)[1] for ln in out.splitlines()
               if ln.startswith("    -> ")]
    idx_names = [m["file"] for m in fa.MNIST_FILES]
    want = [os.path.join(dest, "mnist", n) for n in idx_names]
    present = "FID Inception weights already present" in out
    if not present:
        want.insert(0, os.path.join(dest, fa.FID_WEIGHTS["file"]))
    if code != 1 or planned != want or os.path.exists(dest):
        fail(f"fetch: offline run exited {code}, planned {planned} (want "
             f"{want}), dest written {os.path.exists(dest)}:\n{out}")
    weights = ("already present" if present
               else f"planned ({fa.FID_WEIGHTS['file']})")
    say(f"[fetch] offline --mnist: exit {code}, FID weights {weights}, "
        f"{len(planned) - (not present)} idx files planned "
        f"({', '.join(idx_names)}), nothing written under --dest")

    # a file:// download: installed with its digest prefix, else refused
    os.makedirs(root, exist_ok=True)
    payload = np.random.default_rng(0).bytes(1 << 20)
    src = os.path.join(root, "payload.bin")
    with open(src, "wb") as f:
        f.write(payload)
    digest = hashlib.sha256(payload).hexdigest()
    wrong = ("f" if digest[0] != "f" else "0") + digest[1:8]
    inst = os.path.join(root, "installed")
    good = os.path.join(inst, fa.FID_WEIGHTS["file"])
    with contextlib.redirect_stdout(io.StringIO()):
        fa._download(Path(src).as_uri(), good, digest[:8])
        try:
            fa._download(Path(src).as_uri(), os.path.join(inst, "bad.pth"),
                         wrong)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
    with open(good, "rb") as f:
        installed = f.read() == payload
    left = sorted(os.listdir(inst))
    if not (installed and "digest mismatch" in refused
            and left == [fa.FID_WEIGHTS["file"]]):
        fail(f"fetch: file:// download installed {installed}, wrong prefix "
             f"{refused!r}, left {left}")
    reason = refused.split(" for ")[0]
    say(f"[fetch] file:// download of {len(payload)} bytes: installed with "
        f"prefix {digest[:8]}, refused with {wrong} ({reason}), left {left}")

    # phase 6's idx pair, gzipped under the four names, installed
    gz_dir = os.path.join(root, "gz")
    os.makedirs(gz_dir, exist_ok=True)
    mdest = os.path.join(root, "mnist")
    shapes = {}
    for name in idx_names:
        kind = "images" if "images" in name else "labels"
        raw = glob.glob(os.path.join(mnist_dir, f"train-{kind}-idx*-ubyte"))
        with open(raw[0], "rb") as f, gzip.open(
                os.path.join(gz_dir, name), "wb") as g:
            g.write(f.read())
        shapes[name] = _read_idx(raw[0]).shape
    canonical = dict(zip(idx_names, (m["shape"] for m in fa.MNIST_FILES)))
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            fa._download(Path(gz_dir, idx_names[0]).as_uri(),
                         os.path.join(mdest, idx_names[0]),
                         verify=lambda p: fa._verify_idx(
                             p, canonical[idx_names[0]]))
            shape_refused = ""
        except RuntimeError as e:
            shape_refused = str(e)
        leftover = os.listdir(mdest)
        for name in idx_names:
            fa._download(Path(gz_dir, name).as_uri(),
                         os.path.join(mdest, name),
                         verify=lambda p, s=shapes[name]:
                         fa._verify_idx(p, s))
    found = [find_mnist_files(mdest, train=t) for t in (True, False)]
    same = all(np.array_equal(_read_idx(os.path.join(mdest, n)),
                              _read_idx(os.path.join(gz_dir, n)))
               for n in idx_names)
    code2, out2 = offline(["--dest", dest, "--mnist_dest", mdest,
                           "--mnist"])
    if not ("idx shape" in shape_refused and not leftover
            and all(found) and same and fa._mnist_missing(mdest) == []
            and "MNIST idx files already present" in out2):
        fail(f"fetch: idx install refused {shape_refused!r}, leftover "
             f"{leftover}, found {found}, same {same}, rerun:\n{out2}")
    say(f"[fetch] idx files {idx_names} (shapes "
        f"{[list(s) for s in shapes.values()]}) installed through "
        f"_verify_idx; the canonical {list(canonical[idx_names[0]])} "
        f"refused them, leaving nothing; find_mnist_files finds "
        f"train and t10k; rerun: 'MNIST idx files already present', exit "
        f"{code2}; {time.perf_counter() - t0:.2f} s; card {card}")


def reference_tar(path: str) -> dict:
    """A reference β-VAE-GAN checkpoint at full width, as the reference's
    new_betavaegan.py:221-228 saves it: random tensors from a seed under
    the reference's state_dict key names and shapes (models/model.py:
    381-571), the discriminator behind DataParallel's 'module.' prefix,
    epoch CONVERT_EPOCH. Returns the two state dicts."""
    import torch

    gen = torch.Generator().manual_seed(7)
    rs, hidden, head, n_z = 64, 128, 2048, (256, 8, 8)
    c1, c2, c3 = 256, 128, 32
    a, b, c, d = 32, 128, 256, 256
    feat = 2048

    def conv(sd, key, shape):
        sd[f"{key}.weight"] = torch.randn(shape, generator=gen) * 0.02
        sd[f"{key}.bias"] = torch.randn(shape[1] if "deconv" in key
                                        else shape[0], generator=gen) * 0.02

    def bn(sd, key, n):
        sd[f"{key}.weight"] = 1.0 + 0.1 * torch.randn(n, generator=gen)
        sd[f"{key}.bias"] = 0.1 * torch.randn(n, generator=gen)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(n, generator=gen)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(n, generator=gen)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    vae, disc = {}, {}
    for i, (cin, cout) in enumerate(((3, rs), (rs, 2 * rs),
                                     (2 * rs, 4 * rs))):
        conv(vae, f"features.{3 * i}", (cout, cin, 5, 5))
        bn(vae, f"features.{3 * i + 1}", cout)
    for head_key in ("x_to_mu", "x_to_logvar"):
        conv(vae, f"{head_key}.0", (head, 4 * rs * 8 * 8))
        bn(vae, f"{head_key}.1", head)
        conv(vae, f"{head_key}.3", (hidden, head))
    dim = n_z[0] * n_z[1] * n_z[2]
    conv(vae, "preprocess.0", (dim, hidden))
    bn(vae, "preprocess.1", dim)
    for i, (cin, cout) in enumerate(((n_z[0], c1), (c1, c2), (c2, c3)), 1):
        conv(vae, f"deconv{i}", (cin, cout, 5, 5))
        bn(vae, f"act{i}.0", cout)
    conv(vae, "deconv4", (c3, 3, 5, 5))
    for i, (cin, cout) in enumerate(((3, a), (a, b), (b, c), (c, d))):
        conv(disc, f"convs.{3 * i}", (cout, cin, 5, 5))
        bn(disc, f"convs.{3 * i + 1}", cout)
    conv(disc, "lth_features.0", (feat, d * 8 * 8))
    conv(disc, "sigmoid_output.0", (1, feat))
    torch.save({"epoch": CONVERT_EPOCH, "encoder_decoder_model": vae,
                "discriminator_model": {f"module.{k}": v
                                        for k, v in disc.items()},
                "encoder_decoder_optimizer": {},
                "discriminator_optimizer": {}}, path)
    return {"vae": vae, "disc": disc}


def convert_resume(fl, pin, card: str) -> tuple:
    """``cli.convert --model betavaegan`` of a full-width reference .tar,
    the converted leaves checked against the layout rules written out here
    (OIHW → HWIO; the transposed convolution's (in, out, kh, kw) → HWIO
    flipped; Linear transposed, its flattened input re-ordered from
    (C, H, W) to (H, W, C)), fresh Adam state, the .tar's epoch; then the
    trainer CLI resumes it for one epoch of RESUME_STEPS bf16 steps.
    Returns the resume's launches and fused_linear by path."""
    import contextlib
    import io

    import torch

    from disentangle_mlp_tpu_torch.cli import convert
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    from disentangle_mlp_tpu_torch.utils import msgpack

    tar = os.path.join(RUN_DIR, f"reference_model_{CONVERT_EPOCH}.tar")
    t0 = time.perf_counter()
    ref = reference_tar(tar)
    t_tar = time.perf_counter() - t0
    out = os.path.join(RUN_DIR, "converted", f"model_{CONVERT_EPOCH}")
    t0 = time.perf_counter()
    convert.main(_run_paths("smoke_convert") + [
        "--model", "betavaegan", "--torch_checkpoint", tar, "--output", out,
        "--device", "cuda"])
    t_convert = time.perf_counter() - t0
    raw = msgpack.load(out)
    eg, d = raw["states"]["eg"], raw["states"]["d"]
    lth = ref["disc"]["lth_features.0.weight"]
    want = {
        "eg/params/encoder/conv1/kernel":
            (eg["params"]["encoder"]["conv1"]["kernel"],
             ref["vae"]["features.0.weight"].permute(2, 3, 1, 0)),
        "eg/params/decoder/deconv1/kernel":
            (eg["params"]["decoder"]["deconv1"]["kernel"],
             ref["vae"]["deconv1.weight"].permute(2, 3, 0, 1).flip(0, 1)),
        "eg/params/encoder/mu_fc2/kernel":
            (eg["params"]["encoder"]["mu_fc2"]["kernel"],
             ref["vae"]["x_to_mu.3.weight"].t()),
        "d/params/lth_features/kernel":
            (d["params"]["lth_features"]["kernel"],
             lth.t().reshape(256, 8, 8, -1).permute(1, 2, 0, 3)
             .reshape(256 * 64, -1)),
        "d/batch_stats/bn4/bn/var":
            (d["batch_stats"]["bn4"]["bn"]["var"],
             ref["disc"]["convs.10.running_var"]),
    }
    differ = [k for k, (g, w) in want.items() if not torch.equal(g, w)]
    adam = eg["opt_state"]["0"]
    fresh = int(adam["count"]) == 0 and all(
        not t.any() for _, t in _tree_leaves(adam["mu"]))
    if differ or raw["epoch"] != CONVERT_EPOCH or not fresh:
        fail(f"convert: leaves differ from the layout rules {differ}, epoch "
             f"{raw['epoch']}, fresh Adam state {fresh}")
    size = os.path.getsize(out)
    name = "smoke_resume"
    argv = _run_paths(name) + [
        "--model", "betavaegan", "--device", "cuda", "--load_path", out,
        "--epochs", str(CONVERT_EPOCH + 1), "--synthetic_data", "True",
        "--synthetic_train_size", str(RESUME_STEPS * BATCH),
        "--calc_fid", "False", "--checkpoint_every", "0"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result, launches, by_path, wall = count_launches(
            fl, pin, lambda: train_main(argv))
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("====> Epoch:")]
    if [ln.split()[2] for ln in lines] != [str(CONVERT_EPOCH)]:
        fail(f"convert: the resumed run's epoch lines {lines}, expected "
             f"one of epoch {CONVERT_EPOCH}")
    values = [result[k] for k in RUN_LOSSES["betavaegan"]] + list(
        result["step_metrics"].values())
    if not all(math.isfinite(v) for v in values):
        fail(f"convert: resumed run's losses {result}")
    shapes = [s[:-1] + (s[-1] * RESUME_STEPS,) for s in FUSED_LINEAR_SHAPES]
    check_launches(fl, torch, "convert resume", launches, by_path, shapes, 0,
                   RESUME_STEPS * BN_STEP_LAUNCHES["betavaegan observed"])
    say(f"[convert] reference .tar at full width ({t_tar:.2f} s to write) "
        f"-> {size / 1e9:.3f} GB checkpoint of epoch {raw['epoch']} in "
        f"{t_convert:.2f} s (template on the card, fresh Adam state); "
        f"{len(want)} leaves equal to the layout rules; resumed with "
        f"--epochs {CONVERT_EPOCH + 1}: {lines[0]}; wall {wall:.1f} s incl. "
        f"init and load; launches {json.dumps(launches)}, fused_linear by "
        f"path {json.dumps(by_path)}; card {card}")
    return launches, by_path


# The step kinds of train/scan.py's phases (cli/profile_step.py KINDS): K
# steps per replay in [scan], and fused_linear's launches per step of each
# (the β-VAE-GAN's 21, the VAE's 5, the DCGAN's 7; the families' dense
# layers are float32)
SCAN_K = 4
KIND_LAUNCHES = {"betavaegan observed": LAUNCHES_PER_STEP,
                 "betavaegan intent": LAUNCHES_PER_STEP,
                 "vae": sum(s[-1] for s in STEP_SHAPES["vae"]),
                 "gan": sum(s[-1] for s in STEP_SHAPES["gan"]),
                 "birds": 0, "mnist": 0}


def kind_experiment(model: str, overrides: dict, name: str):
    """One step kind's experiment on the card at full default width (batch
    256, bf16; the families' dense layers float32) and its synthetic
    source."""
    from disentangle_mlp_tpu_torch.cli.profile_step import EXPERIMENTS
    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.data.pipeline import SyntheticSource
    from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
    import torch

    cfg = Config(name=name, batch_size_train=BATCH, dtype="bfloat16",
                 **overrides).finalize(make_dirs=False)
    make = FamilyExperiment if model in ("birds", "mnist") else \
        EXPERIMENTS[model]
    src = SyntheticSource(size=SCAN_K * BATCH, img_size=cfg.img_size,
                          channels=cfg.input_channels, seed=cfg.seed)
    return make(cfg, torch.device("cuda")), src


def _state_names(exp) -> dict:
    """id → name of every parameter and buffer of the experiment's
    modules (the rest of scan.state_tensors are Adam moments and counts)."""
    from torch import nn

    names = {}
    for attr, v in vars(exp).items():
        if isinstance(v, nn.Module):
            for n, t in list(v.named_parameters()) + list(
                    v.named_buffers()):
                names.setdefault(id(t), f"{attr}.{n}")
    return names


def scan_check(fl, pin, card: str) -> list:
    """train/scan.py's make_multi_step against the eager step, each of the
    six step kinds at full default width: from one copied state, SCAN_K
    eager steps twice on the same batches and draws (the card's run-to-run
    spread), then one K = SCAN_K replay of the captured graph. Every metric
    and every parameter, running statistic, Adam moment and count of the
    graphed run within the largest |Δ| between the two eager runs of that
    tensor, or bit-identical where the eager runs are; fused_linear's and
    the BatchNorms' launches of the replay SCAN_K times a step's
    (fused_linear's by path as planned).
    cuDNN runs deterministic algorithms here: with its default choice the
    float32 MNIST step differs from run to run (1e-3 of the loss), and a
    third run lies as often outside that spread as inside it, tensor by
    tensor; deterministic, every eager pair is bit-identical, so the check
    is bit-identity (the five bf16 kinds were bit-identical under the
    default too). Returns each kind's (launches, fused_linear by path)."""
    from disentangle_mlp_tpu_torch.cli.profile_step import KINDS
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = []
    try:
        for kind in KINDS:
            out.append(scan_kind(fl, pin, card, *kind))
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def scan_kind(fl, pin, card: str, label: str, model: str,
              overrides: dict) -> tuple:
    """scan_check's comparison for one step kind."""
    from disentangle_mlp_tpu_torch.train.scan import (make_multi_step,
                                                      state_tensors)
    import torch

    exp, src = kind_experiment(model, overrides, "smoke_scan")
    x, _ = src.load_batch(range(SCAN_K * BATCH))
    batches = torch.from_numpy(x).cuda().reshape(
        (SCAN_K, BATCH) + x.shape[1:])
    draws = [exp.draw(BATCH) for _ in range(SCAN_K)]
    state = state_tensors(exp)
    # detached copies: a clone of a parameter would keep an autograd
    # node of the default stream alive into the capture
    start = [t.detach().clone() for t in state]

    def restore():
        with torch.no_grad():
            for t, v in zip(state, start):
                t.copy_(v)

    def eager():
        restore()
        ms = [exp.train_step(batches[i], draws=draws[i])
              for i in range(SCAN_K)]
        torch.cuda.synchronize()
        return ({k: torch.stack([m[k] for m in ms]) for k in ms[0]},
                [t.detach().clone() for t in state])

    t0 = time.perf_counter()
    m1, s1 = eager()
    t_eager = time.perf_counter() - t0
    m2, s2 = eager()
    restore()
    multi = make_multi_step(exp, SCAN_K)
    t0 = time.perf_counter()
    multi.capture(batches, draws)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    (mg, launches, by_path, t_replay) = count_launches(
        fl, pin, lambda: multi(batches, draws))
    sg = [t.detach().clone() for t in state]
    names = _state_names(exp)
    pairs = [(f"metric {k}", m1[k], m2[k], mg[k]) for k in m1] + [
        (names.get(id(t), f"adam[{i}]"), a, b, g)
        for i, (t, a, b, g) in enumerate(zip(state, s1, s2, sg))]
    worse, spread, dist, identical = [], 0.0, 0.0, [0, 0]
    for name, a, b, g in pairs:
        d_ee = (a.double() - b.double()).abs().max().item()
        d_ge = (g.double() - a.double()).abs().max().item()
        spread, dist = max(spread, d_ee), max(dist, d_ge)
        identical[0] += d_ee == 0
        identical[1] += d_ge == 0
        if d_ge > d_ee:
            worse.append((name, d_ge, d_ee))
    if worse:
        fail(f"[scan] {label}: {len(worse)} of {len(pairs)} tensors of "
             f"the graphed run outside the eager runs' spread, e.g. "
             f"(name, |graph - eager|, |eager - eager|) {worse[:4]}")
    want = {"fused_linear": SCAN_K * KIND_LAUNCHES[label],
            "per_image_normalize": 0,
            "batchnorm": SCAN_K * BN_STEP_LAUNCHES[label],
            "batchnorm_eval": 0,
            "batchnorm_swish": SCAN_K * BN_SWISH_LAUNCHES[label]}
    want_paths = {} if model in ("birds", "mnist") else {
        k: SCAN_K * v for k, v in planned_paths(
            fl, torch, STEP_SHAPES[model]).items()}
    if launches != want or by_path != want_paths:
        fail(f"[scan] {label}: launches {launches} by path {by_path}, "
             f"expected {want} by path {want_paths}")
    finite = all(bool(torch.isfinite(v).all()) for v in mg.values())
    if not finite:
        fail(f"[scan] {label}: non-finite metrics {mg}")
    say(f"[scan] {label}: K={SCAN_K} steps per replay at batch {BATCH}, "
        f"full width; {len(pairs)} tensors (metrics, parameters, "
        f"running statistics, Adam moments and counts): largest |eager "
        f"- eager| {spread:.3e}, largest |graph - eager| {dist:.3e}, "
        f"bit-identical {identical[0]} eager-eager and {identical[1]} "
        f"graph-eager; launches of the replay {json.dumps(launches)}, "
        f"fused_linear by path {json.dumps(by_path)}; wall: {SCAN_K} eager "
        f"steps "
        f"{t_eager * 1e3:.1f} ms, warm-up and capture "
        f"{t_capture * 1e3:.1f} ms, one replay of {SCAN_K} steps "
        f"{t_replay * 1e3:.1f} ms; cuDNN deterministic; card {card}")
    return launches, by_path


def ckpt_async(card: str) -> None:
    """The AsyncCheckpointer on the full-width β-VAE-GAN 'intent' state
    after one step: the ms save() blocks against the seconds until the file
    lands (beside the synchronous writer's seconds); the file byte-identical
    to save_checkpoint's, though every parameter, statistic, moment and
    count changed right after save() returned; keep 2 over three saves
    leaves exactly the two newest files."""
    from disentangle_mlp_tpu_torch.train.scan import state_tensors
    from disentangle_mlp_tpu_torch.utils.checkpoint import (
        AsyncCheckpointer, save_checkpoint)
    import torch

    exp, src = kind_experiment("betavaegan", {"freeze_mode": "intent"},
                               "smoke_ckpt")
    x, _ = src.load_batch(range(BATCH))
    exp.train_step(torch.from_numpy(x).cuda())
    root = os.path.join(RUN_DIR, "ckpt")
    models = os.path.join(root, "models")
    os.makedirs(models, exist_ok=True)
    sync = os.path.join(root, "sync")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(sync, 1, exp.states())
    t_sync = time.perf_counter() - t0
    saver = AsyncCheckpointer()
    t0 = time.perf_counter()
    states = exp.states()
    t_states = time.perf_counter() - t0
    saver.save(os.path.join(models, "model_1"), 1, states, rotate_keep=2)
    with torch.no_grad():
        for t in state_tensors(exp):
            t.add_(1)
    del states
    saver.wait()
    first = dict(saver.last)
    with open(sync, "rb") as a, open(first["path"], "rb") as b:
        if a.read() != b.read():
            fail("[ckpt] async: the file differs from save_checkpoint's of "
                 "the state at save()")
    for n in (2, 3):
        saver.save(os.path.join(models, f"model_{n}"), n, exp.states(),
                   rotate_keep=2)
    saver.wait()
    left = sorted(os.listdir(models))
    if left != ["model_2", "model_3"]:
        fail(f"[ckpt] async: keep 2 left {left}")
    say(f"[ckpt] async: β-VAE-GAN intent state {first['bytes'] / 1e9:.3f} "
        f"GB; states() {t_states * 1e3:.1f} ms, save() blocked "
        f"{first['blocked_s'] * 1e3:.1f} ms, the file landed "
        f"{first['landed_s']:.3f} s after the call (the synchronous writer: "
        f"{t_sync:.3f} s); byte-identical to save_checkpoint's though every "
        f"state tensor changed right after save() returned; keep 2 over 3 "
        f"saves left {left}; card {card}")
    shutil.rmtree(root, ignore_errors=True)


def time_graph(card: str) -> dict:
    """The six step kinds through cli/profile_step.py --model all at full
    width: ms/step by CUDA events, device busy and idle share, kernels a
    step, eager against the one-step graph and make_multi_step with K = 8;
    every variant's fused_linear launches a step as the kind's. Prints the
    earlier [time] birds / mnist step lines from the eager rows. Returns
    the rows by kind."""
    from disentangle_mlp_tpu_torch.cli import profile_step

    rows = profile_step.main(["--name", "prof", "--model", "all",
                              "--calc_fid", "False", "--dtype", "bfloat16"])
    by_kind = {}
    for res in rows:
        kind, parts = res["kind"], []
        for v, m in res["variants"].items():
            if not (math.isfinite(m["ms_per_step"]) and m["ms_per_step"] > 0
                    and m["fused_linear_launches_per_step"]
                    == KIND_LAUNCHES[kind]):
                fail(f"[time] graph {kind} {v}: {m}")
            parts.append(
                f"{v} {m['ms_per_step']:.3f} ms/step (busy "
                f"{m['device_busy_ms_per_step']:.3f}, idle "
                f"{m['device_idle_share']:.3f}, "
                f"{m['device_kernels_per_step']:.0f} kernels, peak "
                f"{m['peak_memory_gib']:.2f} GiB)")
        say(f"[time] graph {kind} (profile_step, batch {res['batch']}, "
            f"{res['steps']} steps each): {'; '.join(parts)}; fused_linear "
            f"{KIND_LAUNCHES[kind]} a step in each; card {card}")
        by_kind[kind] = res
    for dataset in ("birds", "mnist"):
        res = by_kind[dataset]
        cats = {k: round(v, 4)
                for k, v in res["by_category_ms_per_step"].items()}
        say(f"[time] {dataset} step (profile_step eager, batch "
            f"{res['batch']}, {res['steps']} steps): "
            f"{res['ms_per_step']:.3f} ms/step by CUDA events, "
            f"{res['images_per_sec']:.1f} img/s; device busy "
            f"{res['device_busy_ms_per_step']:.3f} ms/step, idle share "
            f"{res['device_idle_share']:.3f}, "
            f"{res['device_kernels_per_step']:.0f} kernels a step; device ms "
            f"by category {json.dumps(cats)}; peak "
            f"{res['peak_memory_gib']:.2f} GiB; card {card}")
    return by_kind


# ---------------------------------------------------------------------------
# 12b. data parallelism (parallel/mesh.py) on the one card
# ---------------------------------------------------------------------------

DDP_W1_STEPS = 4
DDP_W2_STEPS = 3
DDP_RANKS = 2
# two ranks' steps against one process's on the whole batch, as
# tests/test_torch_port_card_training.py compares two devices: each metric
# within its relative bound at each step; each parameter, and each running
# statistic after the first step and after the last, as assert_allclose
# with rtol 1e-3 and the leaf kind's atol. The float32 control takes that
# file's float32 tolerances, the bf16 runs its bf16 ones. Two readings
# walk at full width in either dtype, as a BatchNorm-fed bias does: the
# running statistics of the BatchNorms after the encoder's two 16384-wide
# heads (mu_bn, lv_bn), and the KL term, which reads those heads. Adam's
# sign-like update moves each element of mu_fc1 and lv_fc1 (33.5M each)
# whose gradient lies within rounding noise by ±lr, one and two devices
# round those gradients differently, and each channel's statistic sums
# 16384 of them. The JAX package walks the same way: JAX_WALK is its own
# walk, the full-width float32 β-VAE-GAN 'observed' at batch 256 on two
# CPU devices against one, from one start with the same keys and this
# phase's batches (the synthetic source at the config's seed), 3 steps
# (``python -m tests.test_torch_port_walk --batch 256 --only jax`` on 8
# CPU cores): per step, each walk leaf's largest |Δ| and the KL term's
# relative difference, each as its largest up to that step (a walk's
# envelope). The walk depends on the data: on uniform noise the running
# variances and the KL term walk far less. At batch 32 the port's
# two-rank walk on the CPU is 0.22-1.36 times the JAX package's
# (tests/test_torch_port_walk.py, slow).
# So each walk reading is held at every step to DDP_WALK_MULTIPLE times
# JAX_WALK at that step, never below the bound its kind has without the
# walk (the dtype's statistics atol, the KL term's metric bound). The
# phase runs under cudnn.deterministic, as [scan] does: float32 cuDNN's
# default is not run-to-run deterministic
BF16_METRIC_RTOL = {"recon_enc": 1e-2, "recon_dec": 1e-2, "dis": 1e-2,
                    "D_x": 1e-2, "kld": 1e-1, "sim": 1e-1}
DDP_TOL = {
    "float32": {"metrics": (5e-3, 5e-3, 5e-3), "params": 6e-3,
                "cancelled": 4e-2, "stats": 2e-2},
    "bfloat16": {"metrics": (BF16_METRIC_RTOL,) * 3, "params": 1.2e-2,
                 "cancelled": 4e-2, "stats": 6e-2},
}
DDP_LEAF_RTOL = 1e-3
# the three runs: (key, bn_groups, dtype)
DDP_W2_RUNS = (("float32", 1, "float32"), ("groups1", 1, "bfloat16"),
               ("groups2", 2, "bfloat16"))
# layers whose bias feeds a BatchNorm: no true gradient, a random walk
DDP_BN_CANCELLED = {"conv1", "conv2", "conv3", "conv4", "mu_fc1", "lv_fc1",
                    "preprocess", "deconv1", "deconv2", "deconv3"}
DDP_WALK_LEAVES = {f"encoder.{bn}.running_{s}" for bn in ("mu_bn", "lv_bn")
                   for s in ("mean", "var")}
DDP_WALK_METRICS = {"kld"}
JAX_WALK = {
    "encoder.mu_bn.running_mean": (0.000555, 0.01025, 0.02752),
    "encoder.mu_bn.running_var": (0.0001752, 0.004948, 0.01304),
    "encoder.lv_bn.running_mean": (0.0005651, 0.1716, 0.4553),
    "encoder.lv_bn.running_var": (0.0001333, 0.03643, 0.07329),
    "kld": (0.003089, 0.02695, 0.1834),
}
DDP_WALK_MULTIPLE = 4.0


def _ddp_walk_bound(key: str, step: int, floor: float) -> float:
    """The bound of walk reading ``key`` after ``step`` (from 0)."""
    return max(floor, DDP_WALK_MULTIPLE * JAX_WALK[key][step])


def _ddp_leaf_kind(name: str) -> str:
    parts = name.split(".")
    if name in DDP_WALK_LEAVES:
        return "walk"
    if "running_" in parts[-1]:
        return "stats"
    return ("cancelled" if parts[-1] == "bias" and len(parts) > 1
            and parts[-2] in DDP_BN_CANCELLED else "params")
TOL_DDP_ACTS = {"rtol": 1e-4, "atol": 1e-5}


def _ddp_config(bn_groups: int = 1, dtype: str = "bfloat16"):
    from disentangle_mlp_tpu_torch.config import Config

    return Config(name="smoke_ddp", batch_size_train=BATCH, dtype=dtype,
                  freeze_mode="observed",
                  bn_groups=bn_groups).finalize(make_dirs=False)


def _ddp_batches(steps: int):
    """``steps`` global batches of the synthetic source, on the host."""
    from disentangle_mlp_tpu_torch.data.pipeline import SyntheticSource

    x, _ = SyntheticSource(size=steps * BATCH, seed=_ddp_config().seed
                           ).load_batch(range(steps * BATCH))
    return x.reshape((steps, BATCH) + x.shape[1:])


def _graph_steps(exp, batches) -> tuple:
    """The trainer's stepping on ``batches`` (on the card): the first step
    eager on the capture stream, then replays of the one-step graph; returns
    (the metrics of each step, ms per replayed step)."""
    from disentangle_mlp_tpu_torch.train.scan import make_multi_step
    import torch

    multi = make_multi_step(exp, 1)
    out = [multi.step_and_capture(batches[:1], [exp.draw(BATCH)])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, batches.shape[0]):
        out.append(multi(batches[i:i + 1], [exp.draw(BATCH)]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (batches.shape[0] - 1)
    return [{k: v.clone() for k, v in m.items()} for m in out], ms


def _ddp_w1_rank(mesh, fl, pin, batches) -> tuple:
    """The NCCL world-1 run: the experiment on the mesh, rank 0's state
    broadcast, DDP_W1_STEPS trainer steps, counted."""
    from disentangle_mlp_tpu_torch.parallel import replicate
    from disentangle_mlp_tpu_torch.train.scan import state_tensors
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    import torch

    exp = VAEGANExperiment(_ddp_config(), torch.device("cuda"), mesh=mesh)
    replicate(state_tensors(exp), mesh)
    (metrics, ms), launches, by_path, _ = count_launches(
        fl, pin, lambda: _graph_steps(exp, batches))
    return (metrics, [t.detach().clone() for t in state_tensors(exp)], ms,
            launches, by_path, mesh.backend)


def ddp_nccl_w1(fl, pin, card: str) -> tuple:
    """``[ddp] nccl w1``: the full-width β-VAE-GAN 'observed' on the
    explicit group [cuda:0] over NCCL, world 1, DDP_W1_STEPS steps as the
    trainer steps (the first eager, then the one-step graph with the
    step's all-reduces captured), against the same steps without a mesh:
    every metric and state tensor bit-identical (cuDNN deterministic, as in
    [scan]); fused_linear 21 launches a step, the BatchNorms 80. Returns
    the mesh run's launches and fused_linear by path."""
    from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn
    from disentangle_mlp_tpu_torch.train.scan import state_tensors
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batches = torch.from_numpy(_ddp_batches(DDP_W1_STEPS)).cuda()
        exp = VAEGANExperiment(_ddp_config(), torch.device("cuda"))
        m0, ms0 = _graph_steps(exp, batches)
        s0 = [t.detach().clone() for t in state_tensors(exp)]
        del exp
        (m1, s1, ms1, launches, by_path, backend), = spawn(
            _ddp_w1_rank, make_mesh(devices=["cuda:0"]), fl, pin, batches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if backend != "nccl":
        fail(f"[ddp] nccl w1: the group [cuda:0] ran {backend}")
    differ = [k for a, b in zip(m0, m1) for k in a
              if not torch.equal(a[k], b[k])]
    differ += [i for i, (a, b) in enumerate(zip(s0, s1))
               if not torch.equal(a, b)]
    if differ:
        fail(f"[ddp] nccl w1: {len(differ)} metrics or state tensors differ "
             f"from the run without a mesh, e.g. {differ[:6]}")
    want = {"fused_linear": DDP_W1_STEPS * LAUNCHES_PER_STEP,
            "per_image_normalize": 0,
            "batchnorm": DDP_W1_STEPS * BN_STEP_LAUNCHES["betavaegan observed"],
            "batchnorm_eval": 0, "batchnorm_swish": 0}
    if launches != want:
        fail(f"[ddp] nccl w1: launches {launches}, expected {want}")
    say(f"[ddp] nccl w1: β-VAE-GAN observed at batch {BATCH}, bf16, full "
        f"width, on the group [cuda:0] over {backend}, world 1: "
        f"{DDP_W1_STEPS} steps (the first eager, then one-step graph "
        f"replays with the all-reduces captured); {len(s0)} state tensors "
        f"and {len(m0) * len(m0[0])} metrics bit-identical to the run "
        f"without a mesh; launches {json.dumps(launches)}, fused_linear by "
        f"path {json.dumps(by_path)}; replayed ms/step {ms1:.2f} on the mesh "
        f"against {ms0:.2f} without; card {card}")
    return launches, by_path


def _ddp_leaves(exp) -> list:
    """(name, tensor) of every parameter and buffer of ``exp``, cloned."""
    return [(n, t.detach().clone()) for net in (exp.vae, exp.discriminator)
            for n, t in list(net.named_parameters())
            + list(net.named_buffers())]


def _ddp_walk(exp) -> dict:
    """The walk leaves of ``exp``, cloned."""
    return {n: t.detach().clone() for n, t in exp.vae.named_buffers()
            if n in DDP_WALK_LEAVES}


def _ddp_steps(exp, batches) -> dict:
    """``exp``'s eager steps on ``batches``: each step's metrics and walk
    leaves, every leaf after the first step and after the last."""
    metrics, walk, first = [], [], None
    for x in batches:
        metrics.append({k: v.clone() for k, v in exp.train_step(x).items()})
        walk.append(_ddp_walk(exp))
        if first is None:
            first = _ddp_leaves(exp)
    return {"metrics": metrics, "walk": walk, "first": first,
            "last": _ddp_leaves(exp)}


def _ddp_read(got: dict, want: dict, dtype: str) -> dict:
    """Two runs' readings: each metric's relative difference by step, and
    for each leaf kind the largest |a − b| / (atol + rtol·|b|) (> 1 fails,
    as assert_allclose) with its leaf, its largest |a − b| and largest
    |b|; the running statistics after the first step as ``stats1``; the
    walk leaves after every step, each step to its own atol, as ``walk``
    (with its step), and their largest |a − b| by step as ``walk_abs``."""
    tol = DDP_TOL[dtype]
    out = {"metrics": [{k: abs(float(m[k]) / float(w[k]) - 1) for k in w}
                       for m, w in zip(got["metrics"], want["metrics"])],
           "walk_abs": []}

    def read(kind, name, a, b, atol, **more):
        d = (a.double() - b.double()).abs()
        ratio = (d / (atol + DDP_LEAF_RTOL * b.double().abs())).max()
        if ratio.item() > out.get(kind, {"ratio": -1.0})["ratio"]:
            out[kind] = {"ratio": ratio.item(), "leaf": name,
                         "abs": d.max().item(),
                         "scale": b.abs().max().item(), **more}
        return d.max().item()

    for when in ("first", "last"):
        for (name, a), (_, b) in zip(got[when], want[when]):
            kind = _ddp_leaf_kind(name)
            if kind == "walk" or (when == "first" and kind != "stats"):
                continue
            kind = "stats1" if when == "first" else kind
            read(kind, name, a, b, tol["stats" if kind == "stats1" else kind])
    for i, (g, w) in enumerate(zip(got["walk"], want["walk"])):
        out["walk_abs"].append({
            name: read("walk", name, g[name], b,
                       _ddp_walk_bound(name, i, tol["stats"]), step=i + 1)
            for name, b in w.items()})
    return out


def _ddp_metric_ratio(r: dict, tol: dict) -> float:
    """The largest metric difference over its bound, over the steps (a
    walk metric's bound after the walk)."""
    def bound(i, k):
        t = tol["metrics"][i]
        t = t[k] if isinstance(t, dict) else t
        return _ddp_walk_bound(k, i, t) if k in DDP_WALK_METRICS else t
    return max(e / bound(i, k) for i, step in enumerate(r["metrics"])
               for k, e in step.items())


def _ddp_w2_rank(mesh, ref_path: str) -> dict:
    """One of DDP_RANKS ranks sharing cuda:0 over gloo: each of
    DDP_W2_RUNS, DDP_W2_STEPS eager steps on this rank's slice of each
    global batch (the sliced loader), read against the single process's
    run on the whole batch; then the FID activations of the reference
    decode, this rank extracting its slice. Counts are set to 0 before each
    part and read after it."""
    from disentangle_mlp_tpu_torch.data.pipeline import (DataLoader,
                                                         SyntheticSource)
    from disentangle_mlp_tpu_torch.eval import fid
    from disentangle_mlp_tpu_torch.ops import fused_linear as fl
    from disentangle_mlp_tpu_torch.ops import image_ops as pin
    from disentangle_mlp_tpu_torch.parallel import replicate
    from disentangle_mlp_tpu_torch.train.scan import state_tensors
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    import torch

    if tf32_on():
        raise RuntimeError(f"rank {mesh.rank}: {tf32_state()}; a spawned "
                           f"rank sets the port's float32 policy")
    torch.backends.cudnn.deterministic = True
    ref = torch.load(ref_path, map_location="cuda")
    out = {"launches": {}, "by_path": {}}

    def add(launches, by_path):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        for k, v in by_path.items():
            out["by_path"][k] = out["by_path"].get(k, 0) + v

    for key, groups, dtype in DDP_W2_RUNS:
        cfg = _ddp_config(groups, dtype)
        exp = VAEGANExperiment(cfg, mesh.device, mesh=mesh)
        replicate(state_tensors(exp), mesh)
        loader = DataLoader(SyntheticSource(size=DDP_W2_STEPS * BATCH,
                                            seed=cfg.seed), BATCH,
                            device=mesh.device, process_index=mesh.rank,
                            process_count=mesh.size)
        torch.cuda.synchronize()
        run, launches, by_path, wall = count_launches(
            fl, pin, lambda: _ddp_steps(exp, (x for x, _ in loader)))
        add(launches, by_path)  # the float32 control: BatchNorm's alone
        digest = hashlib.sha256(b"".join(
            t.detach().cpu().numpy().tobytes()
            for t in state_tensors(exp))).hexdigest()
        out[key] = {**_ddp_read(run, ref[key], dtype),
                    "digest": digest, "ms": wall * 1e3 / DDP_W2_STEPS,
                    "launches": launches, "by_path": by_path,
                    "loss": {k: float(v)
                             for k, v in run["metrics"][-1].items()}}
        del exp, loader, run
        torch.cuda.empty_cache()

    def extract():
        return fid.get_activations(ref["decode"], mesh=mesh, normalize=True)

    acts, launches, by_path, wall = count_launches(fl, pin, extract)
    add(launches, by_path)
    want = ref["acts"].cpu().numpy()
    out["fid"] = {"err": float(abs(acts - want).max()),
                  "bad": int((abs(acts - want) > TOL_DDP_ACTS["atol"]
                              + TOL_DDP_ACTS["rtol"] * abs(want)).sum()),
                  "launches": launches, "ms": wall * 1e3,
                  "digest": hashlib.sha256(acts.tobytes()).hexdigest()}
    return out


def ddp_gloo_w2(fl, pin, card: str) -> list:
    """``[ddp] gloo w2`` and ``[ddp] fid``: DDP_RANKS spawned ranks sharing
    cuda:0 over gloo, the full-width β-VAE-GAN 'observed' DDP_W2_STEPS
    eager steps of BATCH / DDP_RANKS rows a rank, each of DDP_W2_RUNS (the
    float32 control, then bf16 with bn_groups 1 and 2), against this
    process's steps on the whole BATCH (same seeds, so the same draws):
    metrics, parameters and running statistics within DDP_TOL of the run's
    dtype, the walk leaves and the KL term at every step within their walk
    bounds (beside what bf16 does to this process against float32, printed
    for scale), every state tensor bit-identical across the ranks,
    fused_linear 21 launches a bf16 step on each rank; then FID activations
    of N_SAMPLES full-width decodes split over the ranks against this
    process's, float32 (TOL_DDP_ACTS), one per_image_normalize launch a
    rank. Every reading is printed before any bound is checked. Returns
    each rank's main-path launches and fused_linear by path."""
    from disentangle_mlp_tpu_torch.eval import fid
    from disentangle_mlp_tpu_torch.eval.samples import _sample_latents
    from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn
    from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
    import torch

    batches = torch.from_numpy(_ddp_batches(DDP_W2_STEPS)).cuda()
    ref = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for key, groups, dtype in DDP_W2_RUNS:
            exp = VAEGANExperiment(_ddp_config(groups, dtype),
                                   torch.device("cuda"))
            ref[key] = _ddp_steps(exp, batches)
            if key == "groups1":
                z = _sample_latents(0, N_SAMPLES, exp.cfg.n_hidden, "cuda")
                ref["decode"] = exp.decode(z)
                ref["acts"] = torch.from_numpy(fid.get_activations(
                    ref["decode"], normalize=True))
            del exp
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # what bf16 rounding does to one process at full width, read as the
    # float32 control is: a run that computed in bf16 would read this
    gap = _ddp_read(ref["groups1"], ref["float32"], "float32")
    os.makedirs(RUN_DIR, exist_ok=True)
    ref_path = os.path.join(RUN_DIR, "ddp_ref.pt")
    torch.save(ref, ref_path)
    del ref, batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_ddp_w2_rank, make_mesh(devices=["cuda:0"] * DDP_RANKS),
                  ref_path)
    wall = time.perf_counter() - t0

    def readings(r: dict) -> str:
        by_step = [{k: float(f"{e:.3e}") for k, e in step.items()}
                   for step in r["metrics"]]
        leaves = {k: {**r[k], "ratio": round(r[k]["ratio"], 4),
                      "abs": float(f"{r[k]['abs']:.3e}"),
                      "scale": float(f"{r[k]['scale']:.3e}")}
                  for k in ("params", "cancelled", "stats1", "stats",
                            "walk")}
        walk = [{k.replace("running_", ""): float(f"{v:.3e}")
                 for k, v in sorted(step.items())} for step in r["walk_abs"]]
        return (f"metric relative differences by step "
                f"{json.dumps(by_step)}; leaves (|a − b| / (atol + "
                f"{DDP_LEAF_RTOL}·|b|), the leaf, its largest |a − b|, "
                f"largest |b|; walk: the walk leaves after every step, as "
                f"{sorted(DDP_WALK_METRICS)}, atol and bound "
                f"max(the kind's, {DDP_WALK_MULTIPLE:g} × JAX_WALK)) "
                f"{json.dumps(leaves)}; walk |a − b| by step "
                f"{json.dumps(walk)}")

    say(f"[ddp] bf16 against float32, one process on {BATCH}, full width, "
        f"read against the float32 bounds: {readings(gap)}; metrics / "
        f"bound {_ddp_metric_ratio(gap, DDP_TOL['float32']):.3f}; card "
        f"{card}")
    failed = []
    for key, groups, dtype in DDP_W2_RUNS:
        res = [r[key] for r in ranks]
        tol = DDP_TOL[dtype]
        worst = max(max(_ddp_metric_ratio(r, tol),
                        *(r[k]["ratio"] for k in ("params", "cancelled",
                                                   "stats1", "stats",
                                                   "walk")))
                    for r in res)
        same = len({r["digest"] for r in res}) == 1
        say(f"[ddp] gloo w2 {dtype} bn_groups {groups}: β-VAE-GAN observed, "
            f"full width, {DDP_RANKS} ranks on cuda:0 over gloo, "
            f"{DDP_W2_STEPS} eager steps of {BATCH // DDP_RANKS} rows a rank "
            f"against one process on {BATCH} in {dtype}: {readings(res[0])}"
            f"; metrics / bound {_ddp_metric_ratio(res[0], tol):.3f}; "
            f"largest error / bound {worst:.3f} (bounds "
            f"{json.dumps(tol)}, leaf rtol {DDP_LEAF_RTOL}); the ranks' "
            f"state {'bit-identical' if same else 'DIFFERENT'}; ms/step "
            f"{', '.join(f'{r['ms']:.1f}' for r in res)} (host-staged "
            f"collectives, a correctness check); launches a rank "
            f"{json.dumps(res[0]['launches'])}, fused_linear by path "
            f"{json.dumps(res[0]['by_path'])}; last step "
            f"{json.dumps(res[0]['loss'])}; card {card}")
        if worst > 1.0:
            failed.append(f"{key}: outside the {dtype} bounds (largest "
                          f"error / bound {worst:.3f})")
        if not same:
            failed.append(f"{key}: the ranks' state differs")
        want = {"fused_linear": DDP_W2_STEPS * LAUNCHES_PER_STEP
                if dtype == "bfloat16" else 0, "per_image_normalize": 0,
                "batchnorm": DDP_W2_STEPS
                * BN_STEP_LAUNCHES["betavaegan observed"],
                "batchnorm_eval": 0, "batchnorm_swish": 0}
        if any(r["launches"] != want for r in res):
            failed.append(f"{key}: launches {[r['launches'] for r in res]}, "
                          f"expected {want} a rank")
    fids = [r["fid"] for r in ranks]
    same = len({f["digest"] for f in fids}) == 1
    say(f"[ddp] fid: pool3 of {N_SAMPLES} full-width decodes over "
        f"{DDP_RANKS} ranks ({N_SAMPLES // DDP_RANKS} each, normalized on "
        f"the rank) against one process, float32: largest |d| "
        f"{max(f['err'] for f in fids):.3e} (tol {json.dumps(TOL_DDP_ACTS)}),"
        f" the ranks' activations {'identical' if same else 'DIFFERENT'}; "
        f"{', '.join(f'{f['ms']:.1f}' for f in fids)} ms a rank; launches a "
        f"rank {json.dumps(fids[0]['launches'])}; all ranks {wall:.1f} s "
        f"with their start; card {card}")
    if any(f["bad"] for f in fids) or not same:
        failed.append(f"fid: activations outside {TOL_DDP_ACTS} "
                      f"({[f['bad'] for f in fids]} elements) or differing "
                      f"between the ranks")
    if any(f["launches"]["per_image_normalize"] != 1 for f in fids):
        failed.append(f"fid: per_image_normalize launches "
                      f"{[f['launches'] for f in fids]}, expected 1 a rank")
    if failed:
        fail(f"[ddp] gloo w2: {'; '.join(failed)}")
    return [(r["launches"], r["by_path"]) for r in ranks]


def train_mesh(card: str) -> None:
    """``[train] mesh``: the trainer with --mesh_shape 2 on one card raises,
    naming the 1 visible device (every other [train] run takes the
    default --mesh_shape 0, the single-device path)."""
    from disentangle_mlp_tpu_torch.cli.train import main as train_main
    import torch

    n = torch.cuda.device_count()
    argv = ["--name", "smoke_mesh", "--device", "cuda", "--mesh_shape", "2",
            "--synthetic_data", "True", "--calc_fid", "False",
            "--save_path", os.path.join(RUN_DIR, "%"),
            "--log_path", os.path.join(RUN_DIR, "%", "log")]
    try:
        train_main(argv)
    except ValueError as e:
        if f"than the {n} visible" not in str(e):
            fail(f"[train] mesh: ValueError {e!r} does not name the {n} "
                 f"visible device(s)")
        say(f"[train] mesh: --mesh_shape 2 on {n} visible device raises "
            f"ValueError: {e}; --mesh_shape 0 (every [train] run above) is "
            f"the single-device path; card {card}")
        return
    fail("[train] mesh: --mesh_shape 2 on one card did not raise")


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
        from disentangle_mlp_tpu_torch.ops import batchnorm as bno
        from disentangle_mlp_tpu_torch.ops import depthwise_conv as dwc
        from disentangle_mlp_tpu_torch.ops import fused_linear as fl
        from disentangle_mlp_tpu_torch.ops import image_ops as pin
    except ImportError as e:
        fail(f"the port's package is not importable from {REPO}: {e}")

    # 1. the card, resolved as the port's entry points resolve theirs
    from disentangle_mlp_tpu_torch.train.loop import resolve_device

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    device = resolve_device("cuda")
    say(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; {device}: {tf32_state()}, as the "
        f"port's resolve_device left it")
    need_float32("[card]")

    # 2. build and check
    t0 = time.perf_counter()
    libs = _build.build_all(["fused_linear", "per_image_normalize",
                             "nvjpeg_decode", "batchnorm",
                             "depthwise_conv"])
    say(f"[build] {', '.join(str(p.name) for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc a source, in parallel; "
        f"flags {' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_logs.items():
        say(f"[build] ptxas {name}: {ptxas_summary(log) or 'no kernels'}")
    worst = check_fused_linear(fl, torch)
    norm_err = check_per_image_normalize(pin, torch)
    bn_err = check_batchnorm(bno, torch)
    dw_err = check_depthwise(dwc, torch)

    # 3. time
    rows = time_fused_linear(fl, torch, card)
    norm_rows = time_per_image_normalize(pin, torch, card)
    bn_times = time_batchnorm(bno, torch, card)
    bn_nvae_times = time_batchnorm_nvae(bno, torch, card)
    dw_times = time_depthwise_nvae(dwc, torch, card)

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        # 3a. NVAE first, while the card's memory is free: its graph holds
        # most of it at batch 128
        runs = [train_nvae(fl, pin, card)]
        # 3b. the CUDA graphs of train/scan.py against the eager steps
        runs += scan_check(fl, pin, card)
        # 4. FID set-up
        stats_path = fid_setup(torch)
        # 5. train: the β-VAE-GAN observed with FID, intent saving its
        # checkpoint; the VAE without FID; the DCGAN with FID
        runs.append(train(fl, pin, "betavaegan", "observed", 4 * BATCH,
                          card, stats_path))
        saved = train(fl, pin, "betavaegan", "intent", 2 * BATCH, card,
                      save=True)
        runs += [saved, train(fl, pin, "vae", "observed", 2 * BATCH, card),
                 train(fl, pin, "gan", "observed", 3 * BATCH, card,
                       stats_path)]
        # 6. eval: sweep the intent run's checkpoint; the async writer
        runs.append(evaluate(fl, pin, saved[2], stats_path, card))
        ckpt_async(card)
        # the families: birds with FID and its checkpoint, MNIST's idx data
        runs.append(train_family(
            fl, pin, "birds", ["--dataset", "birds", "--img_size",
                               str(BIRDS_IMG), "--synthetic_data", "True",
                               "--synthetic_train_size",
                               str(BIRDS_STEPS * BATCH), "--calc_fid", "True",
                               "--n_samples", str(N_SAMPLES),
                               "--fid_path_pretrained", stats_path],
            FAMILY_EPOCHS, fid=True, save=True, card=card))
        mnist_dir = write_mnist(os.path.join(RUN_DIR, "mnist"))
        runs.append(train_family(
            fl, pin, "mnist", ["--dataset", "mnist", "--img_size", "28",
                               "--input_channels", "1", "--image_root_train",
                               mnist_dir, "--synthetic_data", "False",
                               "--calc_fid", "True",
                               "--fid_path_pretrained", stats_path],
            FAMILY_EPOCHS, fid=False, save=False, card=card))
        need_float32("[train] mnist")  # as the trainer left the switches
        # 7. the FID phase, part by part
        split_dir, split_u8 = fid_split(stats_path, card)
        fid_split(stats_path, card, "birds")
        # 8. data: the decoder, the fixture, a JPEG tree two epochs
        data_decoder(card)
        data_fixture(card)
        tree, fid_dir = make_tree(RUN_DIR)
        data_tree(tree, card)
        # 9. train on the tree, FID against a directory; then without FID
        runs.append(train_folder(fl, pin, tree, fid_dir, card))
        runs.append(train_folder(fl, pin, tree, "", card))
        runs.append(train_family(
            fl, pin, "birds folder", ["--dataset", "birds", "--img_size",
                                      str(BIRDS_IMG), "--image_root_train",
                                      tree, "--synthetic_data", "False",
                                      "--calc_fid", "False"],
            1, fid=False, save=False, card=card))
        # 12. the β search, the reproduction, the checkpoint conversion
        bo_posterior(card)
        runs.append(bo_search(fl, pin, stats_path, card))
        runs.append(reproduce_run(fl, pin, card))
        # the asset bootstrap, offline and through file:// URLs
        fetch_check(mnist_dir, card)
        runs.append(convert_resume(fl, pin, card))
        # 12b. data parallelism on the one card
        runs.append(ddp_nccl_w1(fl, pin, card))
        need_float32("[ddp] gloo w2")
        runs += ddp_gloo_w2(fl, pin, card)
        train_mesh(card)
        launches = {k: sum(r[0][k] for r in runs) for k in runs[0][0]}
        by_path = {}
        for paths in (r[1] for r in runs):
            for k, v in paths.items():
                by_path[k] = by_path.get(k, 0) + v
        # 10. FID statistics of a directory
        need_float32("[fid] dir")
        fid_dir_stats(split_dir, split_u8, stats_path, card)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)

    # 11. the six step kinds profiled, eager and graphed; the colour
    # fixture on the card
    time_graph(card)
    need_float32("[time] graph")  # as profile_step left the switches
    data_color(card)

    # 13. report
    by_role = {r["role"]: r for r in rows}

    def step(model: str) -> dict:
        """fused_linear's sums over the launches of one ``model`` step."""
        shapes = STEP_SHAPES[model]

        def total(key):
            return sum(by_role[s[0]][key] * s[-1] for s in shapes)

        t_bytes = total("bytes") / HBM_BYTES_PER_S
        t_ops = total("flops") / BF16_FLOPS_PER_S
        return {"launches": sum(s[-1] for s in shapes),
                "ms": total("ms"), "device_ms": total("device_ms"),
                "plain_ms": total("plain_ms"),
                "library_ms": total("library_ms"),
                "library_cast_ms": total("library_cast_ms"),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    steps = {model: step(model) for model in STEP_SHAPES}
    for model, st in steps.items():
        say(f"[time] fused_linear per {model} step ({st['launches']} "
            f"launches): kernel {st['ms']:.4f} ms, device only "
            f"{st['device_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f} ms, library {st['library_ms']:.4f} ms, "
            f"library with casts {st['library_cast_ms']:.4f} ms; card {card}")
    main_step = steps["betavaegan"]
    kernels = [{
        "name": "fused_linear", "route": "cuda",
        "source": "disentangle_mlp_tpu_torch/csrc/fused_linear.cu",
        "replaces": "disentangle_mlp_tpu/ops/pallas/matmul_fused.py:71",
        "launches": launches["fused_linear"],
        "launches_by_path": by_path,
        "max_abs_err": worst["max_abs_err"],
        "max_rel_err": worst["max_rel_err"],
        "grad_rel_err": worst["grad_rel_err"],
        "ms": main_step["ms"], "plain_ms": main_step["plain_ms"],
        "bound_ms": main_step["bound_ms"], "bound_by": main_step["bound_by"],
        "library_ms": main_step["library_ms"],
        "library_cast_ms": main_step["library_cast_ms"],
        "device_ms": main_step["device_ms"],
        "times_are": f"sums over the {LAUNCHES_PER_STEP} launches of one "
                     f"β-VAE-GAN training step (per_step_by_model: of one "
                     f"step of each experiment; the FID decode's row is per "
                     f"call)",
        "per_step_by_model": steps,
        "shapes": rows,
    }, {
        "name": "per_image_normalize", "route": "cuda",
        "source": "disentangle_mlp_tpu_torch/csrc/per_image_normalize.cu",
        "replaces": "disentangle_mlp_tpu/ops/pallas/image_ops.py:36",
        "launches": launches["per_image_normalize"],
        "max_abs_err": norm_err,
        "ms": norm_rows[0]["ms"], "plain_ms": norm_rows[0]["plain_ms"],
        "bound_ms": norm_rows[0]["bound_ms"],
        "bound_by": norm_rows[0]["bound_by"],
        "device_ms": norm_rows[0]["device_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a per-image min-max "
                        "rescale",
        "times_are": f"per call at {NORM_SHAPE} bf16 in the decoder's NHWC "
                     f"view of NCHW; {NORM_LAUNCHES_PER_EPOCH} launches per "
                     f"FID epoch (shapes: also the birds FID path's "
                     f"{BIRDS_NORM_SHAPE})",
        "shapes": norm_rows,
    }, {
        "name": "batchnorm", "route": "cuda",
        "source": "disentangle_mlp_tpu_torch/csrc/batchnorm.cu",
        "replaces": "no TPU kernel: the ATen passes of models/layers.py's "
                    "BatchNorm and the activation after it",
        "launches": launches["batchnorm"] + launches["batchnorm_eval"],
        "launches_by_path": {"rows": launches["batchnorm"],
                             "eval": launches["batchnorm_eval"],
                             "swish": launches["batchnorm_swish"],
                             "ring": launches["batchnorm"]
                             + launches["batchnorm_eval"],
                             "copies": BN_COPIES["total"]},
        "error_over_tolerance": bn_err,
        "ms": bn_times["per_step"]["kernel_ms"],
        "device_ms": bn_times["per_step"]["kernel_device_ms"],
        "bound_ms": bn_times["per_step"]["bound_ms"], "bound_by": "bytes",
        "two_pass_bound_ms": bn_times["per_step"]["two_pass_bound_ms"],
        "plain_ms": bn_times["per_step"]["plain_ms"],
        "library_ms": bn_times["per_step"]["library_ms"],
        "library_device_ms": bn_times["per_step"]["library_device_ms"],
        "library_note": "F.batch_norm in train mode and the activation in "
                        "place, one call each way",
        "aten_ms": bn_times["per_step"]["aten_ms"],
        "aten_device_ms": bn_times["per_step"]["aten_device_ms"],
        "aten_note": "the ATen chain the kernels replace, forward and "
                     "backward, with its separate activation",
        "times_are": "sums over the BatchNorm calls of one β-VAE-GAN step "
                     "(42 forward, 38 backward)",
        "shapes": bn_times["shapes"],
        "nvae_step_device_ms": bn_nvae_times["per_step"]["device_ms"],
        "nvae_step_bound_ms": bn_nvae_times["per_step"]["bound_ms"],
        "nvae_step_two_pass_bound_ms":
            bn_nvae_times["per_step"]["two_pass_bound_ms"],
        "nvae_shapes": bn_nvae_times["shapes"],
    }, {
        "name": "depthwise_conv", "route": "cuda",
        "source": "disentangle_mlp_tpu_torch/csrc/depthwise_conv.cu",
        "replaces": "no TPU kernel: cuDNN's depthwise 5×5 (F.conv2d with "
                    "groups = C) in models/layers.py's Conv",
        "launches": DW_LAUNCHES["total"],
        "error_over_tolerance": dw_err,
        "ms": dw_times["per_step"]["kernel_ms"],
        "device_ms": dw_times["per_step"]["kernel_ms"],
        "bound_ms": dw_times["per_step"]["bound_ms"], "bound_by": "bytes",
        "plain_ms": dw_times["per_step"]["plain_ms"],
        "library_ms": dw_times["per_step"]["library_ms"],
        "library_note": "F.conv2d with groups = C (cuDNN), forward and "
                        "backward",
        "times_are": "device-only sums over the depthwise calls of one NVAE "
                     "step (72 forward, 72 backward)",
        "per_step": dw_times["per_step"],
        "shapes": dw_times["shapes"],
    }]
    say(json.dumps({"kernels": kernels}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
