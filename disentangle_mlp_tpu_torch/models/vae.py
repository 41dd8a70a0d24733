"""CelebA VAE of the port: convolutional encoder + transposed-conv decoder
(disentangle_mlp_tpu/models/vae.py; reference models/model.py:419-571).

Encoder (64×64×3 → μ, logσ², each n_hidden=128):
    3× [Conv 5×5 stride 2 pad 2 + BN + ReLU]: 3→64→128→256, spatial 64→8;
    flatten 8·8·256 = 16384 in (H, W, C) order → two heads
    [Linear 16384→2048 + BN + ReLU + Linear 2048→n_hidden] for μ and logσ².
Decoder (n_hidden → 64×64×3 in [-1, 1]):
    Linear 128→8·8·256 + BN + ReLU → (8, 8, 256) → 3× [ConvT 5×5 stride 2
    pad 2 out_pad 1 + BN + ReLU]: 256→256→128→32, spatial 8→64; ConvT 5×5
    stride 1 pad 2 → 3 channels, Tanh.

Public functions take and return NHWC images like the JAX package; the
layers run on NCHW inside. μ and logσ² leave the encoder as float32.
Attribute names match the flax modules', so parameters bridge by name
(utils/params.py). The reparameterization noise ε is an argument or is
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import (BatchNorm, Conv, ConvTranspose, Linear, flatten_hwc,
                     nchw_to_nhwc, nhwc_to_nchw)


def draw_normal(like: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normals shaped like ``like`` (float32, on its device)."""
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32)


class CelebaEncoder(nn.Module):
    def __init__(self, n_hidden: int = 128, representation_size: int = 64,
                 head_width: int = 2048, input_channels: int = 3,
                 img_size: int = 64, dtype: torch.dtype = torch.float32,
                 bn_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rs, dt, g = representation_size, dtype, generator

        def bn(c):
            return BatchNorm(c, dtype=dt, groups=bn_groups, generator=g)

        def conv(i, o):
            return Conv(i, o, 5, stride=2, padding=2, dtype=dt, generator=g)

        self.conv1, self.bn1 = conv(input_channels, rs), bn(rs)
        self.conv2, self.bn2 = conv(rs, rs * 2), bn(rs * 2)
        self.conv3, self.bn3 = conv(rs * 2, rs * 4), bn(rs * 4)
        flat = rs * 4 * (img_size // 8) ** 2
        self.mu_fc1 = Linear(flat, head_width, dtype=dt, generator=g)
        self.mu_bn = bn(head_width)
        self.mu_fc2 = Linear(head_width, n_hidden, dtype=dt, generator=g)
        self.lv_fc1 = Linear(flat, head_width, dtype=dt, generator=g)
        self.lv_bn = bn(head_width)
        self.lv_fc2 = Linear(head_width, n_hidden, dtype=dt, generator=g)

    def forward(self, x: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images → (μ, logσ²), both float32."""
        h = nhwc_to_nchw(x)
        h = self.bn1(self.conv1(h), train, activation="relu")
        h = self.bn2(self.conv2(h), train, activation="relu")
        h = self.bn3(self.conv3(h), train, activation="relu")
        h = flatten_hwc(h)
        mu = self.mu_fc2(self.mu_bn(self.mu_fc1(h), train, activation="relu"))
        logvar = self.lv_fc2(self.lv_bn(self.lv_fc1(h), train,
                                        activation="relu"))
        return mu.float(), logvar.float()

    def forward_ref(self, x: torch.Tensor, train: bool = True,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's standalone ``Encoder_celeba.forward`` contract
        (model.py:316-328): (z, per-sample kld) with
        z = μ + ε·exp(0.5·logσ²) and kld = −½ Σ_d (1 + logσ² − μ² − σ²)."""
        mu, logvar = self(x, train=train)
        if eps is None:
            eps = draw_normal(mu, generator)
        z = mu + eps * torch.exp(0.5 * logvar)
        kld = -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar),
                               dim=1)
        return z, kld


class CelebaDecoder(nn.Module):
    def __init__(self, n_hidden: int = 128,
                 n_z: Sequence[int] = (256, 8, 8),
                 channels: Sequence[int] = (256, 128, 32),
                 output_channels: int = 3,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt, g = dtype, generator
        ch, h, w = n_z
        c1, c2, c3 = channels
        self.dtype = dt
        self._reshape_to = (h, w, ch)

        def bn(c):
            return BatchNorm(c, dtype=dt, groups=bn_groups, generator=g)

        def dconv(i, o, s, op):
            return ConvTranspose(i, o, 5, stride=s, padding=2,
                                 output_padding=op, dtype=dt, generator=g)

        self.preprocess = Linear(n_hidden, ch * h * w, dtype=dt, generator=g)
        self.pre_bn = bn(ch * h * w)
        self.deconv1, self.dbn1 = dconv(ch, c1, 2, 1), bn(c1)
        self.deconv2, self.dbn2 = dconv(c1, c2, 2, 1), bn(c2)
        self.deconv3, self.dbn3 = dconv(c2, c3, 2, 1), bn(c3)
        self.deconv4 = dconv(c3, output_channels, 1, 0)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        """(B, n_hidden) latents → NHWC images in the compute dtype."""
        h = self.pre_bn(self.preprocess(z.to(self.dtype)), train,
                        activation="relu")
        h = nhwc_to_nchw(h.reshape((-1,) + self._reshape_to))
        h = self.dbn1(self.deconv1(h), train, activation="relu")
        h = self.dbn2(self.deconv2(h), train, activation="relu")
        h = self.dbn3(self.deconv3(h), train, activation="relu")
        return nchw_to_nhwc(torch.tanh(self.deconv4(h))).to(self.dtype)


class VAE(nn.Module):
    """Encoder + reparameterize + decoder; ``forward`` returns
    (reconstruction, μ, logσ²) like the reference's VAE.forward."""

    def __init__(self, n_hidden: int = 128, n_z: Sequence[int] = (256, 8, 8),
                 representation_size: int = 64, head_width: int = 2048,
                 decoder_channels: Sequence[int] = (256, 128, 32),
                 input_channels: int = 3, img_size: int = 64,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = CelebaEncoder(
            n_hidden=n_hidden, representation_size=representation_size,
            head_width=head_width, input_channels=input_channels,
            img_size=img_size, dtype=dtype, bn_groups=bn_groups,
            generator=generator)
        self.decoder = CelebaDecoder(
            n_hidden=n_hidden, n_z=n_z, channels=decoder_channels,
            output_channels=input_channels, dtype=dtype, bn_groups=bn_groups,
            generator=generator)

    def encode(self, x: torch.Tensor, train: bool = True):
        return self.encoder(x, train=train)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
        return mu + eps * torch.exp(0.5 * logvar)

    def decode(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.decoder(z, train=train)

    def forward(self, x: torch.Tensor, train: bool = True,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self.encode(x, train=train)
        if eps is None:
            eps = draw_normal(mu, generator)
        z = self.reparameterize(mu, logvar, eps)
        return self.decode(z, train=train), mu, logvar
