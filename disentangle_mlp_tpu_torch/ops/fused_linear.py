"""y = act(x · w + b) with bf16 operands and float32 accumulation.

Port of the TPU kernel ``disentangle_mlp_tpu/ops/pallas/matmul_fused.py``
(``fused_linear``, kernel ``_matmul_kernel``) to hand-written CUDA kernels
for Hopper, ``csrc/fused_linear.cu``. Same arguments as the JAX function:
x (M, K), w (K, N), b (N,) or None, ``activation`` in {"none", "relu",
"leaky_relu"} (slope 0.2), ``out_dtype`` defaulting to x's dtype.

- On CUDA tensors :func:`fused_linear` launches a kernel or raises; it
  never computes the result another way. :func:`plan` picks the kernel's
  path from shapes, dtypes, layout and alignment before the launch:
  ``stream`` (TMA-fed wgmma with split-K, for a bf16 x against the float32
  (N, K) weight of the port's Linear), ``dot`` (N < 64) or ``generic``
  (everything else).
- On CPU tensors it uses :func:`fused_linear_plain`, the same function in
  plain PyTorch (the tests run there, and ``chip_smoke.py`` holds the
  kernel against it on the card).
- The gradient is a ``torch.autograd.Function``. The Pallas kernel was
  forward-only and JAX computed the VJP products outside it, so the backward
  here is two bf16 ``torch.matmul`` calls plus a float32 bias sum.

``launches`` counts calls that launched the kernel (one per call, whatever
number of device kernels the path starts; plain-version calls are not
counted), so a run can show that its dense layers went through the kernel;
``path_launches`` splits that count by path.

CUDA graphs (train/scan.py): inside :func:`graph_scope` a call takes its
split-K scratch from the scope's graph, and while that graph is captured
its calls record their launches in the scope instead of the counts (a
capture runs nothing); each replay then adds what the capture recorded
(:func:`replayed`).
"""

from __future__ import annotations

import array
import collections
import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {"generic": 0, "stream": 1, "dot": 2}

# The stream path's tiles (csrc/fused_linear.cu ST_BN, ST_BM, ST_BK) and the
# card it fills, one stream block an SM (an H100 SXM has 132 SMs). With
# splits the launch is cooperative, so tiles · splits must not exceed the
# SMs.
STREAM_TILE_N, STREAM_TILE_M, STREAM_TILE_K = 128, 256, 32
NUM_SMS = 132
# A split takes at least this many K slices, so a split's pipeline fills.
MIN_STEPS_PER_SPLIT = 2
# Below this many output features the dot path's warp per output beats a
# 128-row stream tile that would be mostly masked.
DOT_MAX_N = 63

launches = 0
path_launches: collections.Counter = collections.Counter()
Scratch = Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]
# Split-K scratch of each (device, stream), grown on demand: the float32
# partials and two int32 barrier words a 128 × 256 output tile, which the
# kernel leaves ready for the next launch. Launches on one stream run in
# order, so a call's partials are read before the next call on that stream
# writes its own.
_scratch: Scratch = {}


class GraphScope:
    """What one CUDA graph owns of this kernel: its split-K scratch, which
    the warm-up allocates on the capture stream before the capture (so two
    graphs, or a graph and eager calls, never share one), and the launches
    by path that its capture recorded."""

    def __init__(self):
        self.scratch: Scratch = {}
        self.path_launches: collections.Counter = collections.Counter()


_local = threading.local()


@contextlib.contextmanager
def graph_scope(scope: GraphScope, capturing: bool = False):
    """Calls on this thread use ``scope``'s scratch; with ``capturing``
    their launches are recorded in the scope, not counted."""
    prev = getattr(_local, "scope", None)
    _local.scope = (scope, capturing)
    try:
        yield
    finally:
        _local.scope = prev


def replayed(scope: GraphScope) -> None:
    """Count the launches of one replay of ``scope``'s graph."""
    global launches
    launches += sum(scope.path_launches.values())
    path_launches.update(scope.path_launches)


def _split_scratch(store: Scratch, dev: torch.device, stream: int,
                   ws_bytes: int, tiles: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    ws, bars = store.get((dev.index, stream), (None, None))
    if ws is None or ws.numel() * 4 < ws_bytes or bars.numel() < 2 * tiles:
        ws = torch.empty(max(ws_bytes // 4, ws.numel() if ws is not None
                             else 0), dtype=torch.float32, device=dev)
        bars = torch.zeros(max(2 * tiles, bars.numel() if bars is not None
                               else 0), dtype=torch.int32, device=dev)
        store[dev.index, stream] = ws, bars
    return ws, bars


class Plan(NamedTuple):
    path: str             # "stream", "dot" or "generic"
    splits: int           # K splits of the stream path (1 elsewhere)
    workspace_bytes: int  # float32 partials, splits·M·N·4 when splits > 1


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, x_dtype: torch.dtype,
         w_dtype: torch.dtype, w_nk: bool, aligned: bool = True,
         num_sms: int = NUM_SMS) -> Plan:
    """The path a CUDA launch takes, from shapes, dtypes, the weight's
    layout (``w_nk``: w is the (K, N) view of a contiguous (N, K) tensor),
    whether x's and w's bases are 16-byte aligned, and the card's SMs. TMA
    and the 16-byte vector loads need rows that are a multiple of 16 bytes:
    K % 8 == 0."""
    rows_ok = w_nk and aligned and k % 8 == 0
    if rows_ok and n <= DOT_MAX_N:
        return Plan("dot", 1, 0)
    if rows_ok and x_dtype == torch.bfloat16 and w_dtype == torch.float32:
        tiles = -(-n // STREAM_TILE_N) * -(-m // STREAM_TILE_M)
        k_steps = -(-k // STREAM_TILE_K)
        splits = max(1, min(num_sms // tiles,
                            k_steps // MIN_STEPS_PER_SPLIT))
        return Plan("stream", splits, 4 * splits * m * n if splits > 1
                    else 0)
    return Plan("generic", 1, 0)


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


def weight_layout(w: torch.Tensor) -> bool:
    """True when w (K, N) is the transposed view of a contiguous (N, K)
    weight (the port's Linear passes its weight so), False when w is
    contiguous (K, N); raises for any other layout. With N = 1 both hold
    and the (N, K) reading is taken."""
    k, n = w.shape
    s0, s1 = w.stride()
    if s0 == 1 and (s1 == k or n == 1):
        return True
    if w.is_contiguous():
        return False
    raise ValueError("fused_linear: w must be contiguous (K, N) or the "
                     "transpose of a contiguous (N, K) tensor")


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The plan a CUDA launch on x (M, K) and w (K, N) takes."""
    return plan(x.shape[0], w.shape[1], x.shape[1], x.dtype, w.dtype,
                weight_layout(w), (x.data_ptr() | w.data_ptr()) % 16 == 0,
                _num_sms(x.device.index))


_fn = None


def _lib():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("fused_linear").fused_linear_launch
        fn.argtypes = [ctypes.c_void_p]  # an int64 array, see the source
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            activation: str, out_dtype: torch.dtype,
            force: Optional[Plan] = None) -> torch.Tensor:
    """Check the arguments, plan the path, allocate the output (and the
    split-K scratch) and launch on the current stream of x's device.
    ``force`` replaces the plan (``chip_smoke.py`` times the paths against
    each other with it); the kernel refuses a path that cannot take the
    arguments, and this raises. Kept lean: at the step's small shapes a
    call is bound by the host's time, and the launch's arguments go to the
    library packed in one int64 array, since ctypes converts each argument
    separately."""
    global launches
    x_shape, w_shape = x.shape, w.shape
    if len(x_shape) != 2 or len(w_shape) != 2 or x_shape[1] != w_shape[0]:
        raise ValueError(f"fused_linear: x {tuple(x_shape)} and w "
                         f"{tuple(w_shape)} are not (M, K) and (K, N)")
    m, k = x_shape
    n = w_shape[1]
    x_code, w_code = _DTYPE_CODES.get(x.dtype), _DTYPE_CODES.get(w.dtype)
    if x_code is None or w_code is None:
        raise TypeError(f"fused_linear: x and w must be float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    y_code = _DTYPE_CODES.get(out_dtype)
    if y_code is None:
        raise TypeError(f"fused_linear: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    dev = x.device
    if w.device != dev or (b is not None and b.device != dev):
        raise ValueError("fused_linear: x, w and b must share a device")
    if not x.is_contiguous():
        raise ValueError("fused_linear: x must be contiguous")
    w_nk = weight_layout(w)
    if b is not None and (b.shape != (n,) or b.dtype != torch.float32
                          or not b.is_contiguous()):
        raise ValueError(f"fused_linear: b must be a contiguous float32 "
                         f"({n},) tensor, got {b.dtype} {tuple(b.shape)}")
    if k == 0:
        raise ValueError("fused_linear: K must be positive")
    y = x.new_empty((m, n), dtype=out_dtype)
    if m == 0 or n == 0:
        return y
    xp, wp, index = x.data_ptr(), w.data_ptr(), dev.index
    p = force or plan(m, n, k, x.dtype, w.dtype, w_nk, (xp | wp) % 16 == 0,
                      _num_sms(index))
    stream = torch._C._cuda_getCurrentRawStream(index)
    scope, capturing = getattr(_local, "scope", None) or (None, False)
    ws = bars = 0
    if p.workspace_bytes:
        ws_t, bars_t = _split_scratch(
            _scratch if scope is None else scope.scratch, dev, stream,
            p.workspace_bytes,
            -(-m // STREAM_TILE_M) * -(-n // STREAM_TILE_N))
        ws, bars = ws_t.data_ptr(), bars_t.data_ptr()
    args = array.array("q", (
        xp, x_code, wp, w_code, w_nk, b.data_ptr() if b is not None else 0,
        y.data_ptr(), y_code, m, n, k, ACTIVATIONS[activation],
        PATHS[p.path], p.splits, ws, bars, index, stream))
    err = _lib()(args.buffer_info()[0])
    if err != 0:
        raise RuntimeError(f"fused_linear kernel launch failed: code {err} "
                           f"(M={m}, N={n}, K={k}, {p})")
    if capturing:
        scope.path_launches[p.path] += 1
    else:
        launches += 1
        path_launches[p.path] += 1
    return y


def _forward(x, w, b, activation, out_dtype):
    if x.is_cuda:
        return _launch(x, w, b, activation, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"fused_linear: unsupported device {x.device}")
    if w.device.type != "cpu" or (b is not None and b.device.type != "cpu"):
        raise ValueError("fused_linear: x is on the CPU but w or b is not")
    return fused_linear_plain(x, w, b, activation, out_dtype)


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
    CUDA tensors, the plain version for CPU tensors; differentiable. A call
    that needs no gradient skips the autograd Function's bookkeeping."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            b is not None and b.requires_grad)):
        return FusedLinearFunction.apply(x, w, b, activation, out_dtype)
    return _forward(x, w, b, activation, out_dtype)
