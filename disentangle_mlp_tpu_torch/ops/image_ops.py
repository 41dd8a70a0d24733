"""Per-image min-max rescale to [0, 1]: y = (x − min) · 1/max(max − min, 1e-5)
over each image, in float32.

Port of the TPU kernel ``disentangle_mlp_tpu/ops/pallas/image_ops.py``
(``per_image_normalize_pallas``, kernel ``_normalize_kernel``) to a
hand-written CUDA kernel for Hopper, ``csrc/per_image_normalize.cu``. The FID
path runs it on decoded samples before Inception and before the uint8
sample files (eval/fid.py), as torchvision's ``save_image(normalize=True)``
rescales each file.

- x is (N, H, W, C) float32 or bfloat16; the result is float32 with x's
  shape and strides.
- On CUDA tensors :func:`per_image_normalize` launches the kernel or
  raises. The kernel takes any layout in which each image is one dense
  block of memory (contiguous NHWC, or the NHWC view of a contiguous NCHW
  tensor, which the decoder returns) and walks it in memory order.
- On CPU tensors it uses :func:`per_image_normalize_plain`, the same
  function in plain PyTorch (the tests run there, and ``chip_smoke.py``
  holds the kernel against it on the card).
- NaN propagates: an image holding a NaN comes out all NaN, in both.

``launches`` counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

RANGE_FLOOR = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def per_image_normalize_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per-image amin/amax in
    float32, the reciprocal of the floored range, then the rescale."""
    xf = x.float()
    dims = tuple(range(1, x.dim()))
    lo = xf.amin(dim=dims, keepdim=True)
    hi = xf.amax(dim=dims, keepdim=True)
    scale = 1.0 / torch.clamp(hi - lo, min=RANGE_FLOOR)  # NaN stays NaN
    return (xf - lo) * scale


def _image_is_dense(x: torch.Tensor) -> bool:
    """Each image one dense, non-overlapping block of memory, images one
    block apart: dims 1.. sorted by stride tile their block exactly."""
    per_image = 1
    for size, stride in sorted(zip(x.shape[1:], x.stride()[1:]),
                               key=lambda d: d[1]):
        if size == 1:
            continue
        if stride != per_image:
            return False
        per_image *= size
    return x.shape[0] == 1 or x.stride(0) == per_image


def _lib():
    from . import _build

    lib = _build.load("per_image_normalize")
    fn = lib.per_image_normalize_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, ctypes.c_longlong,
                       ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"per_image_normalize: x must be (N, H, W, C), got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"per_image_normalize: x must be float32 or "
                        f"bfloat16, got {x.dtype}")


def _launch(x: torch.Tensor) -> torch.Tensor:
    """Check the layout, allocate the float32 output with x's strides and
    launch the kernel on the current stream of x's device."""
    global launches
    _check(x)
    if not _image_is_dense(x):
        raise ValueError(
            f"per_image_normalize: each image must be one dense block of "
            f"memory (contiguous NHWC or the NHWC view of contiguous NCHW); "
            f"got strides {x.stride()} for shape {tuple(x.shape)}")
    y = torch.empty_like(x, dtype=torch.float32)
    if x.numel() == 0:
        return y
    launch = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), _DTYPE_CODES[x.dtype], y.data_ptr(),
                     x.shape[0], x[0].numel(), stream)
    if err != 0:
        raise RuntimeError(f"per_image_normalize kernel launch failed: CUDA "
                           f"error {err} (shape {tuple(x.shape)})")
    launches += 1
    return y


def per_image_normalize(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) float32/bfloat16 → float32 per-image min-max rescale:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        _check(x)
        return per_image_normalize_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"per_image_normalize: unsupported device "
                         f"{x.device}")
    return _launch(x)
