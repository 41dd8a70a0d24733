"""y = act(x · w + b) with bf16 operands and float32 accumulation.

Port of the TPU kernel ``disentangle_mlp_tpu/ops/pallas/matmul_fused.py``
(``fused_linear``, kernel ``_matmul_kernel``) to a hand-written CUDA kernel
for Hopper, ``csrc/fused_linear.cu``. Same arguments as the JAX function:
x (M, K), w (K, N), b (N,) or None, ``activation`` in {"none", "relu",
"leaky_relu"} (slope 0.2), ``out_dtype`` defaulting to x's dtype.

- On CUDA tensors :func:`fused_linear` launches the kernel or raises; it
  never computes the result another way.
- On CPU tensors it uses :func:`fused_linear_plain`, the same function in
  plain PyTorch (the tests run there, and ``chip_smoke.py`` holds the
  kernel against it on the card).
- The gradient is a ``torch.autograd.Function``. The Pallas kernel was
  forward-only and JAX computed the VJP products outside it, so the backward
  here is two bf16 ``torch.matmul`` calls plus a float32 bias sum.

``launches`` counts kernel launches (not plain-version calls), so a run can
show that its dense layers went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, LEAKY_SLOPE * y)
    return y


def fused_linear_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       activation: str = "none",
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16-round x and w, multiply
    in float32, add the float32 bias, activate, cast to ``out_dtype``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    out_dtype = out_dtype or x.dtype
    y = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    if b is not None:
        y = y + b.float()
    return _activate(y, activation).to(out_dtype)


def _lib():
    from . import _build

    lib = _build.load("fused_linear")
    fn = lib.fused_linear_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, i, i, vp, vp, i, i, i, i, i, vp]
        fn.restype = i
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            activation: str, out_dtype: torch.dtype) -> torch.Tensor:
    """Check the arguments, allocate the output and launch the kernel on
    the current stream of x's device."""
    global launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_linear: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (K, N)")
    m, k = x.shape
    n = w.shape[1]
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"fused_linear: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_linear: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    devices = {x.device, w.device} | ({b.device} if b is not None else set())
    if len(devices) != 1:
        raise ValueError(f"fused_linear: tensors on several devices {devices}")
    if not x.is_contiguous():
        raise ValueError("fused_linear: x must be contiguous")
    if w.is_contiguous():
        w_nk = 0
    elif w.t().is_contiguous():
        w_nk = 1  # the (K, N) view of an (N, K) weight, read in place
    else:
        raise ValueError("fused_linear: w must be contiguous (K, N) or the "
                         "transpose of a contiguous (N, K) tensor")
    if b is not None and (b.shape != (n,) or b.dtype != torch.float32
                          or not b.is_contiguous()):
        raise ValueError(f"fused_linear: b must be a contiguous float32 "
                         f"({n},) tensor, got {b.dtype} {tuple(b.shape)}")
    if k == 0:
        raise ValueError("fused_linear: K must be positive")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    launch = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), _DTYPE_CODES[x.dtype], w.data_ptr(),
                     _DTYPE_CODES[w.dtype], w_nk,
                     b.data_ptr() if b is not None else None, y.data_ptr(),
                     _DTYPE_CODES[out_dtype], m, n, k,
                     ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"fused_linear kernel launch failed: CUDA error "
                           f"{err} (M={m}, N={n}, K={k})")
    launches += 1
    return y


def _forward(x, w, b, activation, out_dtype):
    if x.device.type == "cpu":
        if w.device.type != "cpu" or (b is not None
                                      and b.device.type != "cpu"):
            raise ValueError("fused_linear: x is on the CPU but w or b is not")
        return fused_linear_plain(x, w, b, activation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear: unsupported device {x.device}")
    return _launch(x, w, b, activation, out_dtype)


class FusedLinearFunction(torch.autograd.Function):
    """Forward through the kernel (plain version on the CPU); backward
    dY' = dY ⊙ act'(y), dX = dY'·Wᵀ, dW = Xᵀ·dY' in bf16 with float32
    accumulation, db = Σ dY' in float32. act' is read from the sign of the
    saved output y, which is exact for relu and leaky_relu."""

    @staticmethod
    def forward(ctx, x, w, b, activation, out_dtype):
        y = _forward(x, w, b, activation, out_dtype)
        ctx.activation = activation
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        g = dy.float()
        if ctx.activation == "relu":
            g = torch.where(y > 0, g, 0.0)
        elif ctx.activation == "leaky_relu":
            g = torch.where(y >= 0, g, LEAKY_SLOPE * g)
        g16 = g.to(torch.bfloat16)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g16 @ w.to(torch.bfloat16).t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # (N, K) product, returned as its (K, N) view: the gradient of a
            # transposed (N, K) weight then lands contiguous
            dw = (g16.t() @ x.to(torch.bfloat16)).t().to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(0)
        return dx, dw, db, None, None


def fused_linear(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, activation: str = "none",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = act(x @ w + b), x (M, K), w (K, N), b (N,): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors; differentiable."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    return FusedLinearFunction.apply(x, w, b, activation,
                                     out_dtype or x.dtype)
