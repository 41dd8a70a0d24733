"""MNIST model family of the port (disentangle_mlp_tpu/models/mnist.py;
reference models/model.py:103-183), NCHW inside, NHWC at the public
functions.

The JAX modules take a ``dtype`` field and use it nowhere: their convs,
transposed convs and dense layers have no dtype and compute in float32 on
float32 inputs, under the bf16 policy too. These modules mirror that and
take no dtype. Every layer has flax's defaults: lecun-normal kernels, zero
biases, flax BatchNorm (scale 1, bias 0).

- :class:`MnistEncoder`: Conv(16, 3×3, pad 1) + BN + ReLU + 2×2 max pool,
  then two heads Conv(4) + BN + ReLU + pool for μ and logσ²; the latent is
  each sample's (H, W, C) map flattened in (H, W, C) order, as the JAX
  package flattens NHWC; returns (z, per-sample KLD).
- :class:`MnistGenerator`: that flat latent back to its (C, H, W) map, two
  2×2 stride-2 transposed convs (flax ``'SAME'`` padding, which is torch's
  padding 0 at k = s = 2) with a ReLU between, sigmoid.
- :class:`MnistDiscriminator`: two valid 3×3 convs with BN + ReLU, Dense
  1024 + ReLU (the features) on the (H, W, C)-flattened map, Dense 1;
  returns (probability or logit, features).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .birds import reparameterize
from .layers import (Conv, ConvTranspose, FlaxBatchNorm, Linear, flatten_hwc,
                     nchw_to_nhwc, nhwc_to_nchw)

LATENT_CHANNELS = 4


def _conv(in_ch, features, padding, generator) -> Conv:
    return Conv(in_ch, features, 3, 1, padding, generator=generator,
                bias="zeros", kernel_init="lecun")


class MnistEncoder(nn.Module):
    def __init__(self, input_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.Conv_0 = _conv(input_channels, 16, 1, g)
        self.BatchNorm_0 = FlaxBatchNorm(16)
        self.Conv_1 = _conv(16, LATENT_CHANNELS, 1, g)
        self.BatchNorm_1 = FlaxBatchNorm(LATENT_CHANNELS)
        self.Conv_2 = _conv(16, LATENT_CHANNELS, 1, g)
        self.BatchNorm_2 = FlaxBatchNorm(LATENT_CHANNELS)

    def forward(self, x: torch.Tensor, eps: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images, ε (B, (H/4)·(W/4)·4) → (z, KLD per sample)."""
        def stage(conv, bn, h):
            return F.max_pool2d(F.relu(bn(conv(h), train)), 2, 2)

        h = stage(self.Conv_0, self.BatchNorm_0, nhwc_to_nchw(x.float()))
        mu = flatten_hwc(stage(self.Conv_1, self.BatchNorm_1, h))
        lv = flatten_hwc(stage(self.Conv_2, self.BatchNorm_2, h))
        return reparameterize(mu, lv, eps)


class MnistGenerator(nn.Module):
    """Flat latent of a (latent_hw, latent_hw, 4) map → (B, 4·hw, 4·hw,
    out_channels) NHWC in [0, 1]."""

    def __init__(self, latent_hw: int = 7, out_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_hw = latent_hw
        g = generator
        self.ConvTranspose_0 = ConvTranspose(
            LATENT_CHANNELS, 16, 2, 2, 0, 0, generator=g, bias="zeros",
            kernel_init="lecun")
        self.ConvTranspose_1 = ConvTranspose(
            16, out_channels, 2, 2, 0, 0, generator=g, bias="zeros",
            kernel_init="lecun")

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        hw = self.latent_hw
        h = nhwc_to_nchw(z.float().reshape(z.shape[0], hw, hw, -1))
        h = F.relu(self.ConvTranspose_0(h))
        return nchw_to_nhwc(torch.sigmoid(self.ConvTranspose_1(h)))


class MnistDiscriminator(nn.Module):
    def __init__(self, input_channels: int = 1, img_size: int = 28,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.Conv_0 = _conv(input_channels, 6, 0, g)
        self.BatchNorm_0 = FlaxBatchNorm(6)
        self.Conv_1 = _conv(6, 12, 0, g)
        self.BatchNorm_1 = FlaxBatchNorm(12)
        self.Dense_0 = Linear(12 * (img_size - 4) ** 2, 1024, generator=g,
                              flax_init=True)
        self.Dense_1 = Linear(1024, 1, generator=g, flax_init=True)

    def forward(self, x: torch.Tensor, train: bool = True,
                return_logits: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images → (probability or logit (B,), features (B, 1024))."""
        h = F.relu(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(x.float())),
                                    train))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h), train))
        feats = F.relu(self.Dense_0(flatten_hwc(h)))
        logit = self.Dense_1(feats).reshape(x.shape[0])
        return (logit if return_logits else torch.sigmoid(logit)), feats
