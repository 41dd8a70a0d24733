"""Depthwise k×k convolution, stride 1, "same" padding (k − 1) / 2, no bias:
y[n, c] = Σ_ij x[n, c, h + i − p, w + j − p]·w[c, 0, i, j], float32 sums
rounded once to the output; an explicit backward.

Hand-written CUDA kernels for Hopper, ``csrc/depthwise_conv.cu``. They
replace no TPU kernel: the JAX package leaves its convolutions to XLA, and
the port ran this one through cuDNN (``F.conv2d`` with ``groups = C``)
until its depthwise 5×5 kernels were the largest of NVAE's step.

Two calls of the kernels, forward and backward:

1. ``forward``: y from x and w.
2. ``backward``: dx (the forward of dy through w turned 180°) and dw (float32
   sums of x·dy per channel and tap) from one read of x and dy; a small
   finalize adds the blocks' dw rows in a fixed order, so dw is the same
   from run to run.

- :func:`is_depthwise` is the rule a convolution takes them by: groups equal
  to its input and output channels, a (C, 1, k, k) weight with k in
  ``KERNEL_SIZES``, stride 1 and padding (k − 1) / 2.
- On CUDA tensors the kernels run or the call raises. They take bf16 or
  float32 x, channels-last (:func:`check`), C a whole number of 16 bytes,
  at most 248 columns (:func:`plan`), and w in x's dtype; y and dx are
  channels-last, dw has w's dtype. A dy with other strides than x's is
  copied first (``path_launches["copies"]``). :func:`plan` cuts the work
  into tiles of (images, rows, every column, a chunk of channels) and
  sizes the ring and the grid from the shape and the card.
- On CPU tensors the same tap loop runs in plain PyTorch (:class:`Plain`),
  float32 throughout.

``launches`` counts calls that ran the kernels, forward and backward each
one; ``path_launches`` splits them into ``fwd`` and ``bwd``. While a CUDA
graph is captured on a stream under :func:`capture_scope`, calls on that
stream record their launches in the scope's counter instead, and each replay
adds them (:func:`replayed`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

KERNEL_SIZES = (3, 5)
PATHS = ("fwd", "bwd")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The walk (csrc/depthwise_conv.cu RUN, FWD_ROWS, VEC, Warps, MAX_STAGES,
# BAR_BYTES, SMEM_BYTES): a thread's run of outputs along w, and its rows
# of them forward; VEC neighbouring channels a thread (4 bytes), so a warp's
# chunk of 32·VEC channels is one 128-byte line of a box; a block's consumer
# warps each way; the ring's stages, RING_BYTES at most, at least 2
# backward where any rows fit; images stacked in a tile while its backward
# stage is under STACK_BYTES.
RUN = 8
FWD_ROWS = 2
VEC = {torch.bfloat16: 2, torch.float32: 1}
WARPS = {2: {"fwd": 15, "bwd": 11}, 1: {"fwd": 23, "bwd": 19}}
MAX_STAGES = 8
BAR_BYTES = 2 * MAX_STAGES * 8
SMEM_BYTES = 227 * 1024
RING_BYTES = 208 * 1024
STACK_BYTES = 32 * 1024
MAX_BOX = 256
ALIGN = 128
# the card's SMs where a plan is made without one (the CPU tests): an H100
H100_SMS = 132

launches = 0
path_launches: collections.Counter = collections.Counter()
# raw handle of a capturing stream -> the launches its capture recorded
_recording: Dict[int, collections.Counter] = {}


@contextlib.contextmanager
def capture_scope(stream, counts: collections.Counter):
    """Calls launched on ``stream`` (a ``torch.cuda.Stream``, from any
    thread) record their launches by path in ``counts`` inside the block
    instead of adding them to the totals: a capture runs nothing."""
    key = stream.cuda_stream
    _recording[key] = counts
    try:
        yield counts
    finally:
        del _recording[key]


def replayed(counts: collections.Counter) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``counts``."""
    global launches
    launches += sum(counts[p] for p in PATHS)
    path_launches.update(counts)


def _count(path: str, stream: int, copies: int = 0) -> None:
    global launches
    rec = _recording.get(stream)
    if rec is None:
        launches += 1
        rec = path_launches
    rec[path] += 1
    if copies:
        rec["copies"] += copies


def is_depthwise(in_ch: int, features: int, groups: int,
                 weight_shape: Sequence[int], stride: int,
                 padding: int) -> bool:
    """Whether a convolution runs through these kernels: every channel its
    own group, a (C, 1, k, k) weight with k in ``KERNEL_SIZES``, stride 1
    and the padding that keeps the size."""
    k = weight_shape[-1]
    return (groups == in_ch == features
            and tuple(weight_shape) == (features, 1, k, k)
            and k in KERNEL_SIZES and stride == 1 and padding == (k - 1) // 2)


def _round_up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class Plan(NamedTuple):
    """How the kernels walk (N, C, H, W) for a k×k kernel: tiles of
    ``images`` images × ``rows`` output rows × ``runs``·RUN columns ×
    ``chunk`` channels (a warp's, ``vec`` a thread; the last chunk may run
    past C), chunk by chunk; ``blocks`` blocks (one an SM), each on a
    contiguous range of the ``tiles`` tiles; ``stages_fwd`` and
    ``stages_bwd`` ring stages."""
    k: int
    elem: int   # bytes an element
    vec: int
    chunk: int
    images: int
    rows: int
    runs: int
    chunks: int
    tiles: int  # of all chunks
    stages_fwd: int
    stages_bwd: int
    blocks: int

    def out_rows(self, backward: bool) -> int:
        """A tile's output rows as its threads take them: FWD_ROWS at a time
        forward."""
        step = 1 if backward else FWD_ROWS
        return -(-self.rows // step) * step

    def halo_bytes(self, backward: bool) -> int:
        """A stage's haloed box: x forward, dy backward."""
        return (self.images * (self.out_rows(backward) + self.k - 1)
                * (self.runs * RUN + self.k - 1) * self.chunk * self.elem)

    def plain_bytes(self) -> int:
        """The backward stage's box of x, no halo."""
        return self.images * self.rows * self.runs * RUN * self.chunk \
            * self.elem

    def stage_bytes(self, backward: bool) -> int:
        return _round_up(self.halo_bytes(backward)) + \
            (_round_up(self.plain_bytes()) if backward else 0)

    def smem(self, backward: bool) -> int:
        """Dynamic shared memory (csrc/depthwise_conv.cu ``geometry``): the
        barriers, backward the dw buffer, the ring."""
        stages = self.stages_bwd if backward else self.stages_fwd
        red = _round_up(4 * self.chunk * self.k ** 2) if backward else 0
        return BAR_BYTES + red + stages * self.stage_bytes(backward)

    def scratch_floats(self) -> int:
        """The backward's dw rows: one (chunk, k²) row a block and chunk it
        meets, (blocks + chunks − 1) of them."""
        return (self.blocks + self.chunks - 1) * self.chunk * self.k ** 2


def chunk_blocks(pl: Plan, q: int) -> range:
    """The blocks whose tile range meets chunk ``q``: the dw rows the
    finalize adds for its channels (csrc/depthwise_conv.cu)."""
    total, per = pl.tiles, pl.tiles // pl.chunks
    a, e = q * per, (q + 1) * per
    first = -(-(a + 1) * pl.blocks // total) - 1
    last = -(-e * pl.blocks // total) - 1
    return range(first, last + 1)


def block_tiles(pl: Plan, b: int) -> range:
    """Tiles of block ``b``, chunk-major."""
    return range(pl.tiles * b // pl.blocks, pl.tiles * (b + 1) // pl.blocks)


@functools.lru_cache(maxsize=256)
def plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
         sms: int = H100_SMS, k: int = 5) -> Plan:
    """The tiles, ring and grid for (N, C, H, W) in ``dtype`` and a k×k
    kernel on a card of ``sms`` SMs; forward and backward walk the same
    tiles. Rows: the most (all of H, or a power of two) for which two
    backward stages fit the ring; a tile that holds all of H stacks images
    while its backward stage is under STACK_BYTES."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"depthwise_conv computes in float32 or bfloat16, "
                        f"not {dtype}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"depthwise_conv: kernel size {k} not in "
                         f"{KERNEL_SIZES}")
    elem = torch.empty((), dtype=dtype).element_size()
    if c * elem % 16:
        raise ValueError(f"depthwise_conv: {c} channels are not a whole "
                         f"number of 16 bytes")
    vec = VEC[dtype]
    cc = 32 * vec
    runs = -(-w // RUN)
    if runs * RUN + k - 1 > MAX_BOX:
        raise ValueError(f"depthwise_conv: width {w} is more than a tensor "
                         f"map's box takes ({MAX_BOX - k + 1})")

    def make(images, rows):
        chunks = -(-c // cc)
        tiles = -(-n // images) * -(-h // rows) * chunks
        blocks = min(sms, tiles)
        per_block = -(-tiles // blocks)
        pl = Plan(k, elem, vec, cc, images, rows, runs, chunks, tiles, 1, 1,
                  blocks)
        fwd, bwd = (max(1, min(MAX_STAGES, per_block,
                               RING_BYTES // pl.stage_bytes(d)))
                    for d in (False, True))
        return pl._replace(stages_fwd=fwd, stages_bwd=bwd)

    def fits(pl):
        return 2 * pl.stage_bytes(True) <= RING_BYTES and \
            pl.out_rows(False) + k - 1 <= MAX_BOX

    rows = [h] + [2 ** m for m in range(1, h.bit_length()) if 2 ** m < h]
    pl = next((make(1, r) for r in sorted(rows, reverse=True)
               if fits(make(1, r))), make(1, min(h, 2)))
    while pl.rows == h and pl.images < min(n, MAX_BOX) and \
            pl.stage_bytes(True) < STACK_BYTES:
        wider = make(2 * pl.images, h)
        if not fits(wider):
            break
        pl = wider
    if pl.smem(True) > SMEM_BYTES or pl.smem(False) > SMEM_BYTES:
        raise ValueError(f"depthwise_conv: no tile of ({n}, {c}, {h}, {w}) "
                         f"fits the {SMEM_BYTES} bytes of shared memory")
    return pl


def _channels_last(t: torch.Tensor) -> bool:
    return t.permute(0, 2, 3, 1).is_contiguous()


def check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raises on a call the kernels do not take: x not a 4-D bf16 or float32
    tensor with its channels contiguous, w not (C, 1, k, k) contiguous in
    x's dtype with k in ``KERNEL_SIZES``, or tensors not 16-byte aligned."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"depthwise_conv computes in float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv: x must be (N, C, H, W), got shape "
                         f"{tuple(x.shape)}")
    c, k = x.shape[1], w.shape[-1]
    if w.dim() != 4 or tuple(w.shape) != (c, 1, k, k) or \
            k not in KERNEL_SIZES:
        raise ValueError(f"depthwise_conv: w must be ({c}, 1, k, k) with k "
                         f"in {KERNEL_SIZES}, got {tuple(w.shape)}")
    if w.dtype != x.dtype or not w.is_contiguous():
        raise ValueError(f"depthwise_conv: w must be contiguous in x's dtype "
                         f"{x.dtype}, got {w.dtype}")
    if not _channels_last(x):
        raise ValueError(f"depthwise_conv: x must be channels-last, got "
                         f"strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("depthwise_conv: x must be 16-byte aligned")


class Plain:
    """The kernels' function in plain PyTorch on x's logical shape: the taps
    added in the kernels' order, float32 throughout, one rounding to the
    output."""

    @staticmethod
    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Float32 y of x (N, C, H, W) and w (C, 1, k, k), in x's memory
        format (channels-last stays so, as the kernels keep it)."""
        k = w.shape[-1]
        p, (h, wd) = (k - 1) // 2, x.shape[2:]
        xp = F.pad(x.float(), (p, p, p, p))
        wf = w.float()[:, 0]
        y = torch.zeros_like(x, dtype=torch.float32)
        for i in range(k):
            for j in range(k):
                y += xp[:, :, i:i + h, j:j + wd] * wf[:, i, j, None, None]
        return y

    @staticmethod
    def forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return Plain.conv(x, w).to(x.dtype)

    @staticmethod
    def backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
        """(dx in x's dtype, dw in w's)."""
        k = w.shape[-1]
        p, (h, wd) = (k - 1) // 2, x.shape[2:]
        dx = torch.empty_like(x).copy_(Plain.conv(dy, w.flip(-2, -1)))
        xp = F.pad(x.float(), (p, p, p, p))
        d = dy.float()
        dw = torch.stack([
            (d * xp[:, :, i:i + h, j:j + wd]).sum((0, 2, 3))
            for i in range(k) for j in range(k)], 1)
        return dx, dw.view(w.shape).to(w.dtype)


_lib_handle = None
_ready: set = set()  # devices whose kernels may take SMEM_BYTES


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from . import _build

        lib = _build.load("depthwise_conv")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dmt_dwconv_forward.argtypes = [vp] * 3 + [i] * 10 + [vp]
        lib.dmt_dwconv_backward.argtypes = [vp] * 6 + [i] * 10 + [vp]
        lib.dmt_dwconv_init.argtypes = []
        for fn in (lib.dmt_dwconv_forward, lib.dmt_dwconv_backward,
                   lib.dmt_dwconv_init):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _device_lib(device: torch.device):
    """The library, its kernels allowed their shared memory on ``device``:
    once a device, at its first call, which the port makes eagerly before
    any capture."""
    lib = _lib()
    if device.index not in _ready:
        _check(lib.dmt_dwconv_init(), "init")
        _ready.add(device.index)
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"depthwise_conv {what} launch failed: code {err}")


class Kernel:
    """The two calls as launches of ``csrc/depthwise_conv.cu`` on the current
    stream of x's device, walking x as :func:`plan` says."""

    @staticmethod
    def _plan(x: torch.Tensor, w: torch.Tensor) -> Plan:
        n, c, h, wd = x.shape
        return plan(n, h, wd, c, x.dtype, _sms(x.device.index), w.shape[-1])

    @staticmethod
    def _dims(x, pl: Plan, stages: int):
        n, c, h, wd = x.shape
        return (_DTYPE_CODES[x.dtype], n, h, wd, c, pl.k, pl.images,
                pl.rows, stages, pl.blocks)

    @staticmethod
    def forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        check(x, w)
        pl = Kernel._plan(x, w)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            err = _device_lib(x.device).dmt_dwconv_forward(
                x.data_ptr(), w.data_ptr(), y.data_ptr(),
                *Kernel._dims(x, pl, pl.stages_fwd), _stream(x))
        _check(err, f"forward ({tuple(x.shape)}, {pl})")
        _count("fwd", _stream(x))
        return y

    @staticmethod
    def backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
        check(x, w)
        copies = 0
        if dy.stride() != x.stride() or dy.data_ptr() % 16:
            dy, copies = torch.empty_like(x).copy_(dy), 1
        pl = Kernel._plan(x, w)
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        scratch = torch.empty(pl.scratch_floats(), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            err = _device_lib(x.device).dmt_dwconv_backward(
                x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                scratch.data_ptr(), dw.data_ptr(),
                *Kernel._dims(x, pl, pl.stages_bwd), _stream(x))
        _check(err, f"backward ({tuple(x.shape)}, {pl})")
        _count("bwd", _stream(x), copies)
        return dx, dw


class DepthwiseConvFunction(torch.autograd.Function):
    """Forward through the kernels (or :class:`Plain`); backward the fused
    dx and dw. Saves x and w, as ``F.conv2d`` does."""

    @staticmethod
    def forward(ctx, x, w, plain):
        ops = Plain if plain or not x.is_cuda else Kernel
        ctx.ops = ops
        ctx.save_for_backward(x, w)
        return ops.forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ctx.ops.backward(x, w, dy)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise convolution of x (N, C, H, W) with w (C, 1, k, k), w
    in x's dtype: the kernels for CUDA tensors, the plain version for CPU
    tensors; differentiable in x and w."""
    return _depthwise_conv(x, w, plain=False)


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`depthwise_conv` through the plain version on any device: what
    the card's tests and ``chip_smoke.py`` hold the kernels against."""
    return _depthwise_conv(x, w, plain=True)


def _depthwise_conv(x, w, plain: bool):
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"depthwise_conv: x and w on one CPU or CUDA device, "
                         f"got {x.device} and {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConvFunction.apply(x, w, plain)
    return (Kernel if x.is_cuda and not plain else Plain).forward(x, w)
