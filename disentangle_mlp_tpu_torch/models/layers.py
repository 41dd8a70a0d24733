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
U(-1/sqrt(fan_in), +1/sqrt(fan_in)). The birds and MNIST families
(models/resnet.py, birds.py, mnist.py) take flax's defaults instead, as the
JAX package's families do: ``kernel_init="lecun"`` (a normal of variance
1/fan_in truncated at ±2σ), zero biases or none (``bias="zeros"`` or
``"none"``), and :class:`FlaxBatchNorm`. Every draw takes an explicit
``torch.Generator``.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import batch_norm
from ..ops.fused_linear import LEAKY_SLOPE, fused_linear
from ..parallel.mesh import all_reduce_sum
from ..utils import runtime

DCGAN_STD = 0.02
_BN_IDS = itertools.count()


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


def _uniform(shape, fan_in, generator):
    bound = 1.0 / (fan_in ** 0.5) if fan_in > 0 else 0.0
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal"): N(0, 1/fan_in) truncated at ±2σ, its std corrected
    for the truncation, drawn by the inverse CDF."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator) * (hi - lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std


def _kernel(shape, fan_in: int, kernel_init: str, generator):
    if kernel_init == "dcgan":
        return _normal(shape, DCGAN_STD, generator)
    if kernel_init == "lecun":
        return _lecun_normal(shape, fan_in, generator)
    if kernel_init == "uniform":  # PyTorch's own Conv2d default
        return _uniform(shape, fan_in, generator)
    raise ValueError(f"unknown kernel_init {kernel_init!r}")


def _bias(features: int, fan_in: int, bias: str, generator):
    """A bias parameter: PyTorch's uniform, flax's zeros, or None."""
    if bias == "none":
        return None
    if bias == "zeros":
        return nn.Parameter(torch.zeros(features))
    if bias == "uniform":
        return nn.Parameter(_uniform((features,), fan_in, generator))
    raise ValueError(f"unknown bias {bias!r}")


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(x)
    if activation == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return x


class Conv(nn.Module):
    """Conv2d(k, stride, padding, groups) on NCHW; weight OIHW, (out,
    in / groups, k, k). ``bias`` is "uniform", "zeros" or "none";
    ``kernel_init`` "dcgan", "lecun" or "uniform" (PyTorch's Conv2d
    default, U(±1/sqrt(fan_in))).

    ``weight_norm`` is NVAE's weight normalisation (Vahdat & Kautz 2020,
    its ``Conv2D``): the kernel used is exp(log_g)·v / (‖v‖ + 1e-5) with
    ‖v‖ each output channel's norm, in float32, then cast to the compute
    dtype; ``log_weight_norm`` (out, 1, 1, 1) starts at log(‖v‖ + 1e-2).
    ``weight_normalized`` holds the float32 kernel of the latest forward
    of a weight-normalised convolution (the spectral regularisation reads
    it, as NVAE's does)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 1, padding: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 bias: str = "uniform", kernel_init: str = "dcgan",
                 groups: int = 1, weight_norm: bool = False):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.groups = groups
        fan_in = in_ch // groups * k * k
        self.weight = nn.Parameter(
            _kernel((features, in_ch // groups, k, k), fan_in, kernel_init,
                    generator))
        self.bias = _bias(features, fan_in, bias, generator)
        self.log_weight_norm = None
        if weight_norm:
            with torch.no_grad():
                norm = self.weight.flatten(1).norm(dim=1)
            self.log_weight_norm = nn.Parameter(
                torch.log(norm + 1e-2).view(-1, 1, 1, 1))
        self.weight_normalized: Optional[torch.Tensor] = None

    def normalized(self) -> torch.Tensor:
        """The float32 kernel the convolution uses."""
        if self.log_weight_norm is None:
            return self.weight
        norm = torch.sqrt(torch.sum(self.weight * self.weight,
                                    dim=[1, 2, 3]))
        return torch.exp(self.log_weight_norm) * self.weight \
            / (norm.view(-1, 1, 1, 1) + 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.normalized()
        if self.log_weight_norm is not None:
            self.weight_normalized = w
        y = F.conv2d(x.to(dt), w.to(dt), None, self.stride, self.padding,
                     1, self.groups)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose(nn.Module):
    """ConvTranspose2d(k, stride, padding, output_padding) on NCHW; weight
    (in, out, kh, kw). ``output_padding=1`` gives the stride-2 8→16→32→64
    ladder of the reference's ``output_size=`` calls (model.py:558-564)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 2, padding: int = 2, output_padding: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 bias: str = "uniform", kernel_init: str = "dcgan"):
        super().__init__()
        if output_padding >= stride and not (stride == 1
                                             and output_padding == 0):
            raise ValueError("output_padding must be smaller than stride")
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.output_padding, self.dtype = output_padding, dtype
        # flax's fan_in of an (kh, kw, in, out) kernel: kh·kw·in
        self.weight = nn.Parameter(_kernel((in_ch, features, k, k),
                                           in_ch * k * k, kernel_init,
                                           generator))
        # PyTorch ConvTranspose2d fan_in = out_channels * k * k
        self.bias = _bias(features, features * k * k, bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Module):
    """Dense layer; weight (out, in). ``activation`` is fused into the
    kernel's epilogue in bf16 and applied after ``F.linear`` in float32."""

    def __init__(self, in_f: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 flax_init: bool = False):
        super().__init__()
        self.dtype = dtype
        if flax_init:  # nn.Dense's defaults: lecun-normal kernel, zero bias
            self.weight = nn.Parameter(_lecun_normal((features, in_f), in_f,
                                                     generator))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
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


class _MarkBackward(torch.autograd.Function):
    """The identity (a view, no kernel) whose backward places a mark: on a
    BatchNorm's output it marks where the BatchNorm's backward begins, on
    its input where it ends."""

    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        runtime.mark(ctx.tag, g)
        return g, None


def marked(tag: str, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` with device marks ``<tag>.fwd.begin``/``.end`` around its
    forward and ``<tag>.bwd.begin``/``.end`` around its backward (views and
    mark kernels: the values are the same)."""
    x = _MarkBackward.apply(x, tag + ".bwd.end")
    runtime.mark(tag + ".fwd.begin", x)
    y = fn(x)
    runtime.mark(tag + ".fwd.end", y)
    return _MarkBackward.apply(y, tag + ".bwd.begin")


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics (eps 1e-5, running-stat decay 0.9,
    E[x²]−E[x]² variance, Bessel-corrected ``running_var``) over every axis
    but the channel axis 1: float32 statistics, compute-dtype output, and
    the ``activation`` that follows it ("none", "relu", "leaky_relu" or
    "swish"), computed in float32 before the one rounding. ``groups > 1`` emulates
    torch DataParallel: contiguous batch groups are normalized with their
    own statistics and only group 0 updates the running statistics
    (disentangle_mlp_tpu/models/layers.py _ManualBN). Its passes are
    ``ops/batchnorm.py``: the hand-written kernels on the card, their plain
    version on the CPU.

    While the port's spans are on (utils/runtime.py), each call places
    device marks ``dmt.bn<k>#<call>.{fwd,bwd}.{begin,end}`` (k numbers the
    BatchNorms in the order they were built) around its forward and its
    backward, activation included, so a profile of a CUDA graph's replay
    can tell the BatchNorms' kernels from the rest; the values computed are
    the same.

    Under a mesh (``mesh``, set by :func:`set_mesh`) the statistics are
    those of the global batch, as the JAX package's sharded step computes
    them: the float32 mean and mean of squares are averaged over the ranks
    in one all-reduce of the 2C vector (the backward's two sums likewise),
    and the Bessel factor counts the global batch. With ``groups`` the
    groups split the global batch, so each rank holds ``groups / ranks``
    whole groups and no statistic crosses ranks; the running statistics of
    group 0, which lies on rank 0, are broadcast from there."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 groups: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.groups = dtype, groups
        self.momentum, self.epsilon = momentum, epsilon
        self.mesh = None
        self._trace_name, self._trace_calls = f"dmt.bn{next(_BN_IDS)}", 0
        self.weight = nn.Parameter(
            1.0 + _normal((features,), DCGAN_STD, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = True,
                activation: str = "none") -> torch.Tensor:
        if not runtime.spans_on():
            return self._normalize(x, train, activation)
        self._trace_calls += 1
        return marked(f"{self._trace_name}#{self._trace_calls}",
                      lambda t: self._normalize(t, train, activation), x)

    def _normalize(self, x: torch.Tensor, train: bool,
                   activation: str = "none") -> torch.Tensor:
        groups, mesh, group0_mesh = 1, self.mesh, None
        if train and self.groups > 1:
            groups, mesh, group0_mesh = self.groups, None, self.mesh
            if group0_mesh is not None:
                groups = local_groups(groups, group0_mesh)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, train=train, groups=groups,
                          momentum=self.momentum, epsilon=self.epsilon,
                          activation=activation, out_dtype=self.dtype,
                          mesh=mesh if train else None,
                          group0_mesh=group0_mesh)


class FlaxBatchNorm(BatchNorm):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` as
    the families use it, on NCHW: float32 batch statistics with the biased
    variance E[x²] − E[x]² (clipped at 0), carried into ``running_var``
    as it is (no Bessel correction); (x − μ)·(rsqrt(σ² + ε)·scale) + bias in
    float32; the result cast to ``dtype`` (the families' ``.astype(dt)``).
    Scale starts at 1 and bias at 0. Its flax leaves sit at
    ``…/BatchNorm_k/{scale, bias}`` and ``{mean, var}`` (utils/params.py).
    A :class:`BatchNorm`, so :func:`train.common.sampling` restores its
    running statistics, and global-batch statistics under a mesh."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        nn.Module.__init__(self)
        self.dtype, self.groups = dtype, 1
        self.momentum, self.epsilon = momentum, epsilon
        self.mesh = None
        self._trace_name, self._trace_calls = f"dmt.bn{next(_BN_IDS)}", 0
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor, n: int,
                bessel: bool = True) -> None:
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            var = (1.0 - m) * var
            if bessel:
                var = var * (n / (n - 1) if n > 1 else 1.0)
            self.running_var.copy_(m * self.running_var + var)

    def _batch_stats(self, x: torch.Tensor):
        """(mean, biased variance, count) over every axis but 1, float32;
        over the global batch under a mesh."""
        axes = (0,) + tuple(range(2, x.dim()))
        xf = x.float()
        mean = xf.mean(axes)
        mean2 = xf.square().mean(axes)
        n = x.numel() // x.shape[1]
        if self.mesh is not None:
            both = all_reduce_sum(torch.cat([mean, mean2]), self.mesh)
            mean, mean2 = (both / self.mesh.size).chunk(2)
            n *= self.mesh.size
        return mean, torch.clamp(mean2 - mean.square(), min=0.0), n

    def _normalize(self, x: torch.Tensor, train: bool,
                   activation: str = "none") -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if train:
            mean, var, n = self._batch_stats(xf)
            self._update(mean.detach(), var.detach(), n, bessel=False)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return activate(y.to(self.dtype), activation)


def local_groups(groups: int, mesh) -> int:
    """The BatchNorm groups of one rank: ``groups`` split the global batch,
    so the ranks must divide them."""
    if groups % mesh.size:
        raise ValueError(f"bn_groups={groups} does not split into whole "
                         f"groups over {mesh.size} ranks: the ranks must "
                         f"divide it")
    return groups // mesh.size


def set_mesh(module: nn.Module, mesh) -> None:
    """Every BatchNorm of ``module`` takes its statistics over ``mesh``'s
    global batch (None: over its own input)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW map in (H, W, C) order, the JAX package's order."""
    return nchw_to_nhwc(x).reshape(x.shape[0], -1)
