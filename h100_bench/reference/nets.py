"""Plain float32 PyTorch of the CelebA 64x64 networks of Larsen et al. 2016
("Autoencoding beyond pixels", arXiv:1512.09300), written from the
reference architecture (models/model.py:388-509 of the original code) and
not from the program under test, which this module never imports.

Every network is a function of a dict of float32 tensors keyed by
``<prefix>.<layer>.<weight|bias|running_mean|running_var>``, torch
layouts: Conv2d (out, in, kh, kw), ConvTranspose2d (in, out, kh, kw),
Linear (out, in).

- Encoder: 3x [Conv 5x5 s2 p2 + BatchNorm + ReLU] 3->64->128->256 over
  64->8 pixels; the 8x8x256 map flattened in (H, W, C) order; two heads
  [Linear 16384->2048 + BatchNorm + ReLU + Linear 2048->128] for mu and
  log sigma^2.
- Decoder: Linear 128->16384 + BatchNorm + ReLU, reshaped (8, 8, 256);
  3x [ConvTranspose 5x5 s2 p2 output_padding 1 + BatchNorm + ReLU]
  256->256->128->32 over 8->64 pixels; ConvTranspose 5x5 s1 p2 -> 3, tanh.
- Discriminator: [Conv 5x5 p2 + BatchNorm + LeakyReLU(0.2)] 3->32 (s1),
  ->128, ->256, ->256 (s2 each); flatten (H, W, C); Linear 16384->2048 +
  LeakyReLU (the Dis_l features); Linear 2048->1 (the logit).

BatchNorm has torch's training semantics: batch mean and biased variance
for the normalisation, eps 1e-5, running statistics moved by 0.1 towards
the batch mean and the Bessel-corrected variance, in place.

``q`` is the precision of the layers: ``q(x)`` rounds an operand (a
convolution's or a dense layer's input or weight) in the forward pass;
``q.out(y)`` rounds an activation (a convolution's or dense layer's
output, a BatchNorm's output) in the forward pass and the gradient that
reaches it in the backward pass. :data:`EXACT` is float32. :data:`FP8`
is the precision below the configurations' bf16, the reference computed
in float8 as float8 training stores it: operands and activations in e4m3,
gradients in e5m2, each tensor under one scale that maps its largest
magnitude to the format's largest value. The benchmark's control runs in
it.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
LEAKY_SLOPE = 0.2
BN_EPS, BN_DECAY = 1e-5, 0.9


class Precision:
    def __init__(self, value: Callable = None, grad: Callable = None):
        self.value, self.grad = value, grad

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.value is None else self.value(x)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.grad is not None:
            y = _GradRound.apply(y, self.grad)
        return self(y)


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax -> 448), the forward
    value only: the gradient passes straight through."""
    with torch.no_grad():
        q = _scaled_round(x.detach(), torch.float8_e4m3fn, 448.0)
    return x + (q - x).detach()


def fp8_e5m2(g: torch.Tensor) -> torch.Tensor:
    """g rounded to float8 e5m2 under one scale (amax -> 57344)."""
    return _scaled_round(g, torch.float8_e5m2, 57344.0)


class _GradRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, fn):
        ctx.fn = fn
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


EXACT = Precision()
FP8 = Precision(fp8_e4m3, fp8_e5m2)


def conv(w: Weights, name: str, x, stride: int, q: Precision):
    return q.out(F.conv2d(q(x), q(w[name + ".weight"]), w[name + ".bias"],
                          stride, 2))


def conv_t(w: Weights, name: str, x, stride: int, out_pad: int,
           q: Precision):
    return q.out(F.conv_transpose2d(q(x), q(w[name + ".weight"]),
                                    w[name + ".bias"], stride, 2, out_pad))


def linear(w: Weights, name: str, x, q: Precision):
    return q.out(F.linear(q(x), q(w[name + ".weight"]), w[name + ".bias"]))


def batch_norm(w: Weights, name: str, x: torch.Tensor,
               q: Precision = EXACT) -> torch.Tensor:
    axes = [0] + list(range(2, x.dim()))
    mean = x.mean(axes)
    var = x.var(axes, unbiased=False)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        rm, rv = w[name + ".running_mean"], w[name + ".running_var"]
        rm.mul_(BN_DECAY).add_((1 - BN_DECAY) * mean)
        rv.mul_(BN_DECAY).add_((1 - BN_DECAY) * var * (n / (n - 1)))
    shape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(var + BN_EPS) * w[name + ".weight"]
    y = (x - mean.view(shape)) * inv.view(shape) \
        + w[name + ".bias"].view(shape)
    return q.out(y)


def flatten_hwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def encoder(w: Weights, p: str, x: torch.Tensor, q: Precision):
    """NHWC images -> (mu, logvar)."""
    h = x.permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        h = torch.relu(batch_norm(w, f"{p}.bn{i}",
                                  conv(w, f"{p}.conv{i}", h, 2, q), q))
    h = flatten_hwc(h)
    out = []
    for head in ("mu", "lv"):
        a = torch.relu(batch_norm(w, f"{p}.{head}_bn",
                                  linear(w, f"{p}.{head}_fc1", h, q), q))
        out.append(linear(w, f"{p}.{head}_fc2", a, q))
    return out[0], out[1]


def decoder(w: Weights, p: str, z: torch.Tensor, q: Precision,
            n_z=(256, 8, 8)) -> torch.Tensor:
    """(B, n_hidden) latents -> NHWC images in [-1, 1]."""
    ch, hh, ww = n_z
    h = torch.relu(batch_norm(w, f"{p}.pre_bn",
                              linear(w, f"{p}.preprocess", z, q), q))
    h = h.reshape(-1, hh, ww, ch).permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        h = torch.relu(batch_norm(w, f"{p}.dbn{i}",
                                  conv_t(w, f"{p}.deconv{i}", h, 2, 1, q),
                                  q))
    return torch.tanh(conv_t(w, f"{p}.deconv4", h, 1, 0, q)
                      ).permute(0, 2, 3, 1)


def discriminator(w: Weights, p: str, x: torch.Tensor, q: Precision):
    """NHWC images -> (logit (B,), Dis_l features (B, 2048))."""
    h = x.permute(0, 3, 1, 2)
    for i, s in ((1, 1), (2, 2), (3, 2), (4, 2)):
        h = F.leaky_relu(batch_norm(w, f"{p}.bn{i}",
                                    conv(w, f"{p}.conv{i}", h, s, q), q),
                         LEAKY_SLOPE)
    f = F.leaky_relu(linear(w, f"{p}.lth_features", flatten_hwc(h), q),
                     LEAKY_SLOPE)
    return linear(w, f"{p}.sigmoid_output", f, q).squeeze(-1), f


def bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits, target.expand(logits.shape))


def kld(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(1 + logvar - mu.square() - logvar.exp())


def sum_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().sum()


class Adam:
    """torch.optim.Adam's defaults as optax applies them: one step count
    for the bias corrections, a missing gradient taken as zero."""

    def __init__(self, params, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.zeros_like(p) if g is None else g
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def tf32_off() -> None:
    """float32 means float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
