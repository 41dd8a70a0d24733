"""ResNet-18 feature extractor of the port, for the birds encoder
(disentangle_mlp_tpu/models/resnet.py; the reference wraps torchvision's
pretrained resnet18, models/model.py:16-21).

NHWC images in, the 512-d global-average-pooled features out (float32).
Convolutions compute in the model's dtype with no bias; each BatchNorm is
flax's (float32 statistics and output, cast back to the dtype); the
residual add and ReLU run in the dtype; the pooled mean is taken in float32,
rounded to the dtype and returned as float32, as ``jnp.mean(...).astype``
does. Submodules carry flax's compact names (``ConvBN_0`` the stem,
``BasicBlock_0..7``, each with ``ConvBN_0``/``ConvBN_1`` and, where it
downsamples, ``ConvBN_2``; a ConvBN holds ``Conv_0`` and ``BatchNorm_0``),
so utils/params.py bridges the JAX package's tree.

:func:`load_torch_state_dict` puts a torchvision ``resnet18().state_dict()``
straight into a :class:`ResNet18Features` (OIHW kernels as they are, BN
weight/bias and running statistics; ``fc.*`` dropped, as the reference
replaces the classifier); :func:`load_torch_checkpoint` reads one from disk
with ``torch.load(weights_only=True)`` (no torchvision needed) and returns
None when the file is absent, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, FlaxBatchNorm, nhwc_to_nchw

WIDTHS = (64, 128, 256, 512)


class ConvBN(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride, kernel // 2,
                           dtype=dtype, generator=generator, bias="none",
                           kernel_init="lecun")
        self.BatchNorm_0 = FlaxBatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x), train)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ConvBN_0 = ConvBN(in_ch, features, 3, stride, dtype, g)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, dtype, g)
        if stride != 1 or in_ch != features:
            self.ConvBN_2 = ConvBN(in_ch, features, 1, stride, dtype, g)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = F.relu(self.ConvBN_0(x, train))
        out = self.ConvBN_1(out, train)
        identity = self.ConvBN_2(x, train) if hasattr(self, "ConvBN_2") else x
        return F.relu(out + identity)


class ResNet18Features(nn.Module):
    """NHWC image → (B, 512) float32 pooled features."""

    def __init__(self, in_ch: int = 3, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(in_ch, 64, 7, 2, dtype, generator)
        ch = 64
        # two blocks a stage; the first of stages 2-4 halves the map
        for k in range(2 * len(WIDTHS)):
            width, stride = WIDTHS[k // 2], 2 if k in (2, 4, 6) else 1
            setattr(self, f"BasicBlock_{k}",
                    BasicBlock(ch, width, stride, dtype, generator))
            ch = width
        self.n_blocks = 2 * len(WIDTHS)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = F.relu(self.ConvBN_0(nhwc_to_nchw(x), train))
        h = F.max_pool2d(h, 3, 2, 1)  # lax.reduce_window's -inf padding
        for k in range(self.n_blocks):
            h = getattr(self, f"BasicBlock_{k}")(h, train)
        return h.float().mean((2, 3)).to(self.dtype).float()


def _torch_pairs(sd: Dict) -> Dict[str, tuple]:
    """The port's ConvBN path → torchvision's (conv, bn) key prefixes."""
    pairs = {"ConvBN_0": ("conv1", "bn1")}
    for layer in range(1, 5):
        for b in range(2):
            pre, idx = f"layer{layer}.{b}", 2 * (layer - 1) + b
            pairs[f"BasicBlock_{idx}.ConvBN_0"] = (f"{pre}.conv1",
                                                   f"{pre}.bn1")
            pairs[f"BasicBlock_{idx}.ConvBN_1"] = (f"{pre}.conv2",
                                                   f"{pre}.bn2")
            if f"{pre}.downsample.0.weight" in sd:
                pairs[f"BasicBlock_{idx}.ConvBN_2"] = (f"{pre}.downsample.0",
                                                       f"{pre}.downsample.1")
    return pairs


def load_torch_state_dict(model: ResNet18Features, sd: Dict) -> None:
    """A torchvision ``resnet18().state_dict()`` (tensors or arrays) into
    ``model`` in place; ``fc.*`` is ignored. Every ConvBN of the model must
    find its keys, with matching shapes."""
    pairs = _torch_pairs(sd)
    mods = dict(model.named_modules())
    missing = sorted(set(n for n, m in mods.items()
                         if isinstance(m, ConvBN)) - set(pairs))
    if missing:
        raise ValueError(f"resnet18 state dict: no keys for {missing}")

    def t(key):
        return torch.as_tensor(sd[key])

    with torch.no_grad():
        for name, (conv, bn) in pairs.items():
            m = mods[name]
            for dst, src in ((m.Conv_0.weight, t(f"{conv}.weight")),
                             (m.BatchNorm_0.weight, t(f"{bn}.weight")),
                             (m.BatchNorm_0.bias, t(f"{bn}.bias")),
                             (m.BatchNorm_0.running_mean,
                              t(f"{bn}.running_mean")),
                             (m.BatchNorm_0.running_var,
                              t(f"{bn}.running_var"))):
                if tuple(dst.shape) != tuple(src.shape):
                    raise ValueError(f"resnet18 state dict: {name} takes "
                                     f"{tuple(dst.shape)}, got "
                                     f"{tuple(src.shape)}")
                dst.copy_(src)


def load_torch_checkpoint(model: ResNet18Features, path: str
                          ) -> Optional[ResNet18Features]:
    """Load a torchvision resnet18 checkpoint file into ``model``; returns
    the model, or None (and leaves it as it was) when the file is absent."""
    if not path or not os.path.isfile(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    load_torch_state_dict(model, sd)
    return model
