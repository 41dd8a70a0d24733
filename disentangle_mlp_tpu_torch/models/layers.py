"""Building-block layers of the port: PyTorch modules with the JAX package's
numerics (disentangle_mlp_tpu/models/layers.py).

Layout: every layer here works on NCHW (cuDNN's layout); the models convert
from and to the JAX package's NHWC at their public functions, and flatten in
(H, W, C) order, so a dense kernel of the JAX package is this port's weight
transposed with no permutation (utils/params.py).

Cast points follow the JAX package under the bf16 policy: inputs and
weights are cast to the compute dtype, convolution biases are added in the
compute dtype, BatchNorm statistics are float32 and its output is in the
compute dtype. A bf16 :class:`Linear` runs through the hand-written
``fused_linear`` kernel (bf16 operands, float32 accumulation and bias); a
float32 one through ``F.linear``, as JAX computes its float32 product
outside any Pallas kernel.

Initialization matches the reference's ``weights_init`` (model.py:8-13):
conv kernels ~ N(0, 0.02²), BatchNorm scale ~ N(1, 0.02²) and bias 0;
Linear layers and conv biases keep PyTorch's default
U(-1/sqrt(fan_in), +1/sqrt(fan_in)). Every draw takes an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_linear import LEAKY_SLOPE, fused_linear

DCGAN_STD = 0.02


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


def _uniform(shape, fan_in, generator):
    bound = 1.0 / (fan_in ** 0.5) if fan_in > 0 else 0.0
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(x)
    if activation == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return x


class Conv(nn.Module):
    """Conv2d(k, stride, padding) on NCHW; weight OIHW."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 1, padding: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            _normal((features, in_ch, k, k), DCGAN_STD, generator))
        self.bias = nn.Parameter(_uniform((features,), in_ch * k * k,
                                          generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding)
        return y + self.bias.to(dt)[:, None, None]


class ConvTranspose(nn.Module):
    """ConvTranspose2d(k, stride, padding, output_padding) on NCHW; weight
    (in, out, kh, kw). ``output_padding=1`` gives the stride-2 8→16→32→64
    ladder of the reference's ``output_size=`` calls (model.py:558-564)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 2, padding: int = 2, output_padding: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if output_padding >= stride and not (stride == 1
                                             and output_padding == 0):
            raise ValueError("output_padding must be smaller than stride")
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.output_padding, self.dtype = output_padding, dtype
        self.weight = nn.Parameter(
            _normal((in_ch, features, k, k), DCGAN_STD, generator))
        # PyTorch ConvTranspose2d fan_in = out_channels * k * k
        self.bias = nn.Parameter(_uniform((features,), features * k * k,
                                          generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding)
        return y + self.bias.to(dt)[:, None, None]


class Linear(nn.Module):
    """Dense layer; weight (out, in). ``activation`` is fused into the
    kernel's epilogue in bf16 and applied after ``F.linear`` in float32."""

    def __init__(self, in_f: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_uniform((features, in_f), in_f,
                                            generator))
        self.bias = nn.Parameter(_uniform((features,), in_f, generator))

    def forward(self, x: torch.Tensor,
                activation: str = "none") -> torch.Tensor:
        if self.dtype == torch.bfloat16:
            # the kernel rounds x and the float32 weight to bf16 as it loads
            return fused_linear(x.contiguous(), self.weight.t(), self.bias,
                                activation, out_dtype=torch.bfloat16)
        if self.dtype != torch.float32:
            raise ValueError(f"Linear computes in bfloat16 or float32, "
                             f"not {self.dtype}")
        return activate(F.linear(x.float(), self.weight, self.bias),
                        activation)


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics (eps 1e-5, running-stat decay 0.9,
    E[x²]−E[x]² variance, Bessel-corrected ``running_var``) over every axis
    but the channel axis 1: float32 statistics, compute-dtype output.
    ``groups > 1`` emulates torch DataParallel: contiguous batch groups are
    normalized with their own statistics and only group 0 updates the
    running statistics (disentangle_mlp_tpu/models/layers.py _ManualBN)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 groups: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.groups = dtype, groups
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(
            1.0 + _normal((features,), DCGAN_STD, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        bessel = n / (n - 1) if n > 1 else 1.0
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var * bessel)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.dtype
        if train and self.groups > 1:
            return self._grouped(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(axes)
            mean2 = xf.square().mean(axes)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            self._update(mean.detach(), var.detach(), x.numel() // x.shape[1])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        # (x − μ)·inv + β folded into x·inv + (β − μ·inv)
        shift = self.bias - mean * inv
        return x.to(dt) * inv.to(dt).view(shape) + shift.to(dt).view(shape)

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        g, b = self.groups, x.shape[0]
        if b % g:
            raise ValueError(f"bn_groups={g} must divide the batch ({b})")
        xg = x.reshape((g, b // g) + tuple(x.shape[1:])).float()
        axes = (1,) + tuple(range(3, xg.dim()))
        gmean = xg.mean(axes)                                   # (g, C)
        gmean2 = xg.square().mean(axes)
        gvar = torch.clamp(gmean2 - gmean.square(), min=0.0)    # biased
        self._update(gmean[0].detach(), gvar[0].detach(),
                     xg[0].numel() // x.shape[1])
        inv = torch.rsqrt(gvar + self.epsilon) * self.weight    # (g, C)
        shift = self.bias - gmean * inv
        shape = (g, 1, -1) + (1,) * (x.dim() - 2)
        dt = self.dtype
        y = xg.to(dt) * inv.to(dt).view(shape) + shift.to(dt).view(shape)
        return y.reshape(x.shape)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW map in (H, W, C) order, the JAX package's order."""
    return nchw_to_nhwc(x).reshape(x.shape[0], -1)
