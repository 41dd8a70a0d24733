"""InceptionV3 pool3 feature extractor for FID, inference-only
(disentangle_mlp_tpu/eval/inception.py).

The FID-patched InceptionV3 of the reference's scoring/inception.py, as
``nn.Module``s on NCHW:

- BatchNorm is folded into each convolution at load time, so every layer is
  a convolution with bias, then ReLU (:class:`FoldedConv`);
- average-pool branches exclude padded zeros from the divisor
  (``count_include_pad=False``, TF semantics);
- the second InceptionE (Mixed_7c) max-pools in its pool branch;
- features stop at the global average pool: (N, 2048).

Convolutions go to cuDNN (on the CPU, to PyTorch's CPU kernels): Inception
is no kernel of this package. Parameters live in the JAX package's layout,
a nested dict ``{name: {"kernel": HWIO, "bias": (cout,)}}`` (Mixed blocks
one level deeper), so both packages load one tree; ``utils/params.py``
moves a tree into the module (``inception_from_jax``) and back.

Weights come from the pt_inception-2015-12-05 checkpoint when it is found
(``find_fid_weights``); otherwise a seeded random He-normal network is used,
so the FID pipeline stays runnable end to end. Its scores are then
self-consistent but not comparable to published FIDs, and its numbers
differ from the JAX package's random network (another generator).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------
# Architecture spec: name -> (kh, kw, cin, cout, stride, (pad_h, pad_w)),
# torchvision-compatible module names so torch checkpoints map 1:1.
# --------------------------------------------------------------------------


def _conv(kh, kw, cin, cout, stride=1, pad=(0, 0)):
    return (kh, kw, cin, cout, stride, pad)


def _inception_a(cin: int, pool_features: int) -> Dict[str, tuple]:
    return {
        "branch1x1": _conv(1, 1, cin, 64),
        "branch5x5_1": _conv(1, 1, cin, 48),
        "branch5x5_2": _conv(5, 5, 48, 64, pad=(2, 2)),
        "branch3x3dbl_1": _conv(1, 1, cin, 64),
        "branch3x3dbl_2": _conv(3, 3, 64, 96, pad=(1, 1)),
        "branch3x3dbl_3": _conv(3, 3, 96, 96, pad=(1, 1)),
        "branch_pool": _conv(1, 1, cin, pool_features),
    }


def _inception_b(cin: int) -> Dict[str, tuple]:
    return {
        "branch3x3": _conv(3, 3, cin, 384, stride=2),
        "branch3x3dbl_1": _conv(1, 1, cin, 64),
        "branch3x3dbl_2": _conv(3, 3, 64, 96, pad=(1, 1)),
        "branch3x3dbl_3": _conv(3, 3, 96, 96, stride=2),
    }


def _inception_c(cin: int, c7: int) -> Dict[str, tuple]:
    return {
        "branch1x1": _conv(1, 1, cin, 192),
        "branch7x7_1": _conv(1, 1, cin, c7),
        "branch7x7_2": _conv(1, 7, c7, c7, pad=(0, 3)),
        "branch7x7_3": _conv(7, 1, c7, 192, pad=(3, 0)),
        "branch7x7dbl_1": _conv(1, 1, cin, c7),
        "branch7x7dbl_2": _conv(7, 1, c7, c7, pad=(3, 0)),
        "branch7x7dbl_3": _conv(1, 7, c7, c7, pad=(0, 3)),
        "branch7x7dbl_4": _conv(7, 1, c7, c7, pad=(3, 0)),
        "branch7x7dbl_5": _conv(1, 7, c7, 192, pad=(0, 3)),
        "branch_pool": _conv(1, 1, cin, 192),
    }


def _inception_d(cin: int) -> Dict[str, tuple]:
    return {
        "branch3x3_1": _conv(1, 1, cin, 192),
        "branch3x3_2": _conv(3, 3, 192, 320, stride=2),
        "branch7x7x3_1": _conv(1, 1, cin, 192),
        "branch7x7x3_2": _conv(1, 7, 192, 192, pad=(0, 3)),
        "branch7x7x3_3": _conv(7, 1, 192, 192, pad=(3, 0)),
        "branch7x7x3_4": _conv(3, 3, 192, 192, stride=2),
    }


def _inception_e(cin: int) -> Dict[str, tuple]:
    return {
        "branch1x1": _conv(1, 1, cin, 320),
        "branch3x3_1": _conv(1, 1, cin, 384),
        "branch3x3_2a": _conv(1, 3, 384, 384, pad=(0, 1)),
        "branch3x3_2b": _conv(3, 1, 384, 384, pad=(1, 0)),
        "branch3x3dbl_1": _conv(1, 1, cin, 448),
        "branch3x3dbl_2": _conv(3, 3, 448, 384, pad=(1, 1)),
        "branch3x3dbl_3a": _conv(1, 3, 384, 384, pad=(0, 1)),
        "branch3x3dbl_3b": _conv(3, 1, 384, 384, pad=(1, 0)),
        "branch_pool": _conv(1, 1, cin, 192),
    }


INCEPTION_SPEC: Dict[str, object] = {
    "Conv2d_1a_3x3": _conv(3, 3, 3, 32, stride=2),
    "Conv2d_2a_3x3": _conv(3, 3, 32, 32),
    "Conv2d_2b_3x3": _conv(3, 3, 32, 64, pad=(1, 1)),
    "Conv2d_3b_1x1": _conv(1, 1, 64, 80),
    "Conv2d_4a_3x3": _conv(3, 3, 80, 192),
    "Mixed_5b": _inception_a(192, 32),
    "Mixed_5c": _inception_a(256, 64),
    "Mixed_5d": _inception_a(288, 64),
    "Mixed_6a": _inception_b(288),
    "Mixed_6b": _inception_c(768, 128),
    "Mixed_6c": _inception_c(768, 160),
    "Mixed_6d": _inception_c(768, 160),
    "Mixed_6e": _inception_c(768, 192),
    "Mixed_7a": _inception_d(768),
    "Mixed_7b": _inception_e(1280),
    "Mixed_7c": _inception_e(2048),
}

FEATURE_DIM = 2048
RANDOM_SEED = 20151205
INPUT_SIZE = 299


# --------------------------------------------------------------------------
# Params (JAX-package layout: HWIO kernels, numpy float32)
# --------------------------------------------------------------------------

def init_random_params(seed: int = 0) -> Dict:
    """Deterministic He-normal random weights, the no-pretrained-file
    fallback, drawn from one seeded ``torch.Generator`` in spec order."""
    gen = torch.Generator().manual_seed(seed)

    def leaf(spec):
        kh, kw, cin, cout, _, _ = spec
        k = torch.randn((kh, kw, cin, cout), generator=gen)
        return {"kernel": (k * np.sqrt(2.0 / (kh * kw * cin))).numpy(),
                "bias": np.zeros((cout,), np.float32)}

    return {name: ({b: leaf(s) for b, s in spec.items()}
                   if isinstance(spec, dict) else leaf(spec))
            for name, spec in INCEPTION_SPEC.items()}


def fold_bn_into_conv(weight_oihw: np.ndarray, bn_gamma: np.ndarray,
                      bn_beta: np.ndarray, bn_mean: np.ndarray,
                      bn_var: np.ndarray, eps: float = 1e-3
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(conv → BN) ≡ (scaled conv → bias): kernel·γ/√(σ²+ε), β − μ·γ/√(σ²+ε).
    Returns HWIO kernel + bias."""
    scale = bn_gamma / np.sqrt(bn_var + eps)
    w = weight_oihw * scale[:, None, None, None]
    b = bn_beta - bn_mean * scale
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32), b.astype(np.float32)


def load_torch_fid_weights(path: str) -> Dict:
    """Convert the pt_inception-2015-12-05 torch checkpoint (the FID weights
    the reference's scoring/inception.py:13 downloads) into the folded-BN
    params tree."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() for k, v in sd.items()}

    def leaf(prefix):
        k, b = fold_bn_into_conv(
            sd[f"{prefix}.conv.weight"], sd[f"{prefix}.bn.weight"],
            sd[f"{prefix}.bn.bias"], sd[f"{prefix}.bn.running_mean"],
            sd[f"{prefix}.bn.running_var"])
        return {"kernel": k, "bias": b}

    return {name: ({b: leaf(f"{name}.{b}") for b in spec}
                   if isinstance(spec, dict) else leaf(name))
            for name, spec in INCEPTION_SPEC.items()}


WEIGHT_SEARCH_PATHS = (
    os.environ.get("FID_INCEPTION_WEIGHTS", ""),
    "/home/shared/evaluation/fid/pt_inception-2015-12-05-6726825d.pth",
    os.path.expanduser(
        "~/.cache/torch/hub/checkpoints/pt_inception-2015-12-05-6726825d.pth"),
    os.path.expanduser(
        "~/.cache/disentangle_mlp_tpu/pt_inception-2015-12-05-6726825d.pth"),
)


def find_fid_weights() -> Optional[str]:
    for p in WEIGHT_SEARCH_PATHS:
        if p and os.path.isfile(p):
            return p
    return None


@functools.lru_cache(maxsize=1)
def get_params_cached() -> Tuple[Dict, bool]:
    """(params, pretrained?): the real FID weights when available."""
    path = find_fid_weights()
    if path is not None:
        return load_torch_fid_weights(path), True
    return init_random_params(seed=RANDOM_SEED), False


# --------------------------------------------------------------------------
# Modules (NCHW)
# --------------------------------------------------------------------------

class FoldedConv(nn.Module):
    """Convolution with its BatchNorm folded in (weight OIHW, bias), then
    ReLU. The bias is added in float32, as the JAX package adds it to the
    float32 convolution output."""

    def __init__(self, spec: tuple):
        super().__init__()
        kh, kw, cin, cout, stride, pad = spec
        self.stride, self.padding = stride, tuple(pad)
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        return torch.relu(y.float() + self.bias[:, None, None]).to(x.dtype)


def _block(spec: Dict[str, tuple]) -> nn.ModuleDict:
    return nn.ModuleDict({name: FoldedConv(s) for name, s in spec.items()})


def _max_pool(x, stride=2, pad=0):
    return F.max_pool2d(x, 3, stride=stride, padding=pad)


def _avg_pool_exclude_pad(x):
    """TF-semantics average pool: the divisor counts only in-bounds taps
    (the FID patch, reference scoring/inception.py:209-212)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _chain(x, block, names):
    for n in names:
        x = block[n](x)
    return x


def _run_block_a(x, p):
    return torch.cat([
        p["branch1x1"](x),
        _chain(x, p, ["branch5x5_1", "branch5x5_2"]),
        _chain(x, p, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
        p["branch_pool"](_avg_pool_exclude_pad(x)),
    ], dim=1)


def _run_block_b(x, p):
    return torch.cat([
        p["branch3x3"](x),
        _chain(x, p, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
        _max_pool(x),
    ], dim=1)


def _run_block_c(x, p):
    return torch.cat([
        p["branch1x1"](x),
        _chain(x, p, ["branch7x7_1", "branch7x7_2", "branch7x7_3"]),
        _chain(x, p, ["branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                      "branch7x7dbl_4", "branch7x7dbl_5"]),
        p["branch_pool"](_avg_pool_exclude_pad(x)),
    ], dim=1)


def _run_block_d(x, p):
    return torch.cat([
        _chain(x, p, ["branch3x3_1", "branch3x3_2"]),
        _chain(x, p, ["branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                      "branch7x7x3_4"]),
        _max_pool(x),
    ], dim=1)


def _run_block_e(x, p, pool: str):
    b3 = p["branch3x3_1"](x)
    bd = _chain(x, p, ["branch3x3dbl_1", "branch3x3dbl_2"])
    if pool == "max":  # Mixed_7c FID patch (scoring/inception.py:302-307)
        bp = _max_pool(x, stride=1, pad=1)
    else:
        bp = _avg_pool_exclude_pad(x)
    return torch.cat([
        p["branch1x1"](x),
        p["branch3x3_2a"](b3), p["branch3x3_2b"](b3),
        p["branch3x3dbl_3a"](bd), p["branch3x3dbl_3b"](bd),
        p["branch_pool"](bp),
    ], dim=1)


class InceptionV3(nn.Module):
    """The FID-patched InceptionV3 up to the global average pool, on NCHW
    input already resized to 299×299 and scaled to [-1, 1]."""

    def __init__(self):
        super().__init__()
        for name, spec in INCEPTION_SPEC.items():
            setattr(self, name, _block(spec) if isinstance(spec, dict)
                    else FoldedConv(spec))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _max_pool(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool(x)
        for n in ["Mixed_5b", "Mixed_5c", "Mixed_5d"]:
            x = _run_block_a(x, getattr(self, n))
        x = _run_block_b(x, self.Mixed_6a)
        for n in ["Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"]:
            x = _run_block_c(x, getattr(self, n))
        x = _run_block_d(x, self.Mixed_7a)
        x = _run_block_e(x, self.Mixed_7b, pool="avg")
        x = _run_block_e(x, self.Mixed_7c, pool="max")
        return x.float().mean(dim=(2, 3))  # global average pool


@contextlib.contextmanager
def _cudnn_tf32_off():
    """float32 convolutions in full float32: PyTorch lets cuDNN use TF32
    by default, whose ~3 significant digits through 94 convolutions are the
    drift the float32 FID contract refuses (eval/fid.py FEATURE_DTYPE)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def pool3_features(model: InceptionV3, images01: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC images in [0, 1] → (N, 2048) float32 pool3 activations, on the
    images' device.

    Bilinear resize to 299×299 (half-pixel centres: ``align_corners=False``,
    no antialias, which only matters when shrinking), then 2x − 1, then the
    network in ``dtype`` (float32 by default, with TF32 off)."""
    with torch.no_grad(), _cudnn_tf32_off():
        x = images01.float().permute(0, 3, 1, 2)
        if x.shape[2] != INPUT_SIZE or x.shape[3] != INPUT_SIZE:
            x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE),
                              mode="bilinear", align_corners=False,
                              antialias=False)
        return model((2.0 * x - 1.0).to(dtype))
