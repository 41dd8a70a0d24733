"""CelebA DCGAN generator and feature-returning discriminator of the port
(disentangle_mlp_tpu/models/gan.py; reference models/model.py:331-416).

``DiscriminatorCeleba``: Conv(3→32, s1) → Conv(32→128, s2) →
Conv(128→256, s2) → Conv(256→256, s2), each 5×5 pad 2 + BN + LeakyReLU(0.2)
(fused into the BatchNorm's passes);
flatten 8·8·256 in (H, W, C) order → Linear→2048 + LeakyReLU (the ``Dis_l``
feature layer, float32 at the boundary) → Linear 2048→1. ``forward``
returns (probability, features), or (logit, features) with
``return_logits=True``. In bf16 the Dis_l LeakyReLU runs in the
``fused_linear`` kernel's epilogue.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import BatchNorm, Conv, Linear, flatten_hwc, nhwc_to_nchw
from .vae import CelebaDecoder


class GeneratorCeleba(CelebaDecoder):
    """Latent (B, n_hidden) → image (B, 64, 64, 3) in [-1, 1]."""


class DiscriminatorCeleba(nn.Module):
    def __init__(self, input_channels: int = 3,
                 channels: Sequence[int] = (32, 128, 256, 256),
                 feature_dim: int = 2048, img_size: int = 64,
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt, g = dtype, generator
        c1, c2, c3, c4 = channels

        def bn(c):
            return BatchNorm(c, dtype=dt, groups=bn_groups, generator=g)

        def conv(i, o, s):
            return Conv(i, o, 5, stride=s, padding=2, dtype=dt, generator=g)

        self.conv1, self.bn1 = conv(input_channels, c1, 1), bn(c1)
        self.conv2, self.bn2 = conv(c1, c2, 2), bn(c2)
        self.conv3, self.bn3 = conv(c2, c3, 2), bn(c3)
        self.conv4, self.bn4 = conv(c3, c4, 2), bn(c4)
        flat = c4 * (img_size // 8) ** 2
        self.lth_features = Linear(flat, feature_dim, dtype=dt, generator=g)
        self.sigmoid_output = Linear(feature_dim, 1, dtype=dt, generator=g)

    def forward(self, x: torch.Tensor, train: bool = True,
                return_logits: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images → (probability or logit (B,), Dis_l features (B, F)),
        both float32."""
        h = nhwc_to_nchw(x)
        h = self.bn1(self.conv1(h), train, activation="leaky_relu")
        h = self.bn2(self.conv2(h), train, activation="leaky_relu")
        h = self.bn3(self.conv3(h), train, activation="leaky_relu")
        h = self.bn4(self.conv4(h), train, activation="leaky_relu")
        features = self.lth_features(flatten_hwc(h),
                                     activation="leaky_relu").float()
        logit = self.sigmoid_output(features).float().squeeze(-1)
        if return_logits:
            return logit, features
        return torch.sigmoid(logit), features
