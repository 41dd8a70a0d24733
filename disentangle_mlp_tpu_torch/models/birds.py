"""Birds model family of the port (disentangle_mlp_tpu/models/birds.py;
reference models/model.py:16-100), NCHW inside, NHWC at the public
functions.

- :class:`BirdsEncoder`: ResNet-18 features (models/resnet.py) → μ/logσ²
  heads ``x_to_mu``/``x_to_logvar``, flax ``nn.Dense`` layers with no dtype
  on float32 features, so float32 ``Linear``s (``F.linear``, not the bf16
  ``fused_linear`` kernel); returns (z, per-sample KLD).
- :class:`BirdsGenerator`: z → 512·4·4 → … → 3×128×128 tanh through six
  bias-free transposed convs ``_CT_0..5`` (N(0, 0.02²) kernels) in the
  compute dtype; flax BatchNorm after ``_CT_1..4`` (``BatchNorm_0..3``),
  none after the first; ReLU, LeakyReLU 0.01 on the fifth stage.
- :class:`BirdsDiscriminator`: bias-free 4×4 stride-2 convs ``Conv_0..4``
  (N(0, 0.02²)), BatchNorm after ``Conv_1..4``, LeakyReLU 0.2, then the 4×4
  valid ``Conv_5`` with a bias → one logit; returns (probability or logit,
  float32 avg-pooled 512-d features).

The JAX ``_CT`` correlates the input dilated by the stride and padded by
k − 1 − p with the kernel, which is ``conv_transpose2d`` with padding p and
the kernel flipped (utils/params.py's ConvTranspose layout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, ConvTranspose, FlaxBatchNorm, Linear,
                     nchw_to_nhwc, nhwc_to_nchw)
from .resnet import ResNet18Features

FEATURES = 512


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z = μ + ε·exp(½logσ²) and the KLD per sample, summed over the latent
    dimension only."""
    z = mu + eps * torch.exp(0.5 * logvar)
    kld = -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar),
                           dim=1)
    return z, kld


class BirdsEncoder(nn.Module):
    def __init__(self, n_z: int = 128, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 input_channels: int = 3):
        super().__init__()
        self.resnet = ResNet18Features(input_channels, dtype, generator)
        self.x_to_mu = Linear(FEATURES, n_z, generator=generator,
                              flax_init=True)
        self.x_to_logvar = Linear(FEATURES, n_z, generator=generator,
                                  flax_init=True)

    def forward(self, x: torch.Tensor, eps: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images, ε (B, n_z) → (z, KLD per sample), float32."""
        feats = self.resnet(x, train)
        return reparameterize(self.x_to_mu(feats), self.x_to_logvar(feats),
                              eps)


def _ct(in_ch: int, features: int, stride: int, padding: int, dtype,
        generator) -> ConvTranspose:
    return ConvTranspose(in_ch, features, 4, stride, padding, 0, dtype=dtype,
                         generator=generator, bias="none")


class BirdsGenerator(nn.Module):
    def __init__(self, n_z: int = 128, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        chans = (n_z, 512, 384, 192, 96, 64, 3)
        for k in range(6):
            stride, pad = (1, 0) if k == 0 else (2, 1)
            setattr(self, f"_CT_{k}", _ct(chans[k], chans[k + 1], stride, pad,
                                          dtype, g))
        for k in range(4):
            setattr(self, f"BatchNorm_{k}", FlaxBatchNorm(chans[k + 2],
                                                          dtype=dtype))

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        """(B, n_z) → (B, 128, 128, 3) NHWC in [-1, 1], compute dtype."""
        h = F.relu(self._CT_0(z.reshape(z.shape[0], -1, 1, 1)))   # 1→4
        for k in range(1, 5):                                       # 4→64
            h = getattr(self, f"BatchNorm_{k - 1}")(
                getattr(self, f"_CT_{k}")(h), train)
            h = F.relu(h) if k < 4 else F.leaky_relu(h, 0.01)
        return nchw_to_nhwc(torch.tanh(self._CT_5(h)).to(self.dtype))


class BirdsDiscriminator(nn.Module):
    def __init__(self, input_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        chans = (input_channels, 64, 128, 256, 512, 512)
        for k in range(5):
            setattr(self, f"Conv_{k}", Conv(chans[k], chans[k + 1], 4, 2, 1,
                                            dtype=dtype, generator=g,
                                            bias="none"))
        for k in range(4):
            setattr(self, f"BatchNorm_{k}", FlaxBatchNorm(chans[k + 2],
                                                          dtype=dtype))
        self.Conv_5 = Conv(512, 1, 4, 1, 0, dtype=dtype, generator=g,
                           bias="zeros")

    def forward(self, x: torch.Tensor, train: bool = True,
                return_logits: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images → (probability or logit (B,), features (B, 512)),
        both float32."""
        def lrelu(h):
            return F.leaky_relu(h, 0.2)

        h = lrelu(self.Conv_0(nhwc_to_nchw(x)))
        for k in range(1, 5):
            h = lrelu(getattr(self, f"BatchNorm_{k - 1}")(
                getattr(self, f"Conv_{k}")(h), train))
        logit = self.Conv_5(h).reshape(x.shape[0]).float()
        feats = h.float().mean((2, 3)).to(self.dtype).float()
        return (logit if return_logits else torch.sigmoid(logit)), feats
