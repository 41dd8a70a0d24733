"""BatchNorm with torch semantics and the activation that follows it
(ReLU, LeakyReLU or Swish, z·σ(z)): statistics over every axis but 1,
float32; y = act(x·inv + shift) in the compute dtype; an explicit
backward.

Hand-written CUDA kernels for Hopper, ``csrc/batchnorm.cu``. They replace no
TPU kernel: the JAX package leaves BatchNorm to XLA
(``disentangle_mlp_tpu/models/layers.py`` ``_ManualBN``), and the port ran it
as a chain of ATen passes until they were the largest share of the step.

Train mode, forward (three launches; four under a mesh):

1. ``reduce``: float32 partial sums of x and x² per channel, one row a block.
2. ``finalize``: a group's rows summed in a fixed order; mean, mean2 =
   E[x], E[x²]; var = max(mean2 − mean², 0); rstd = rsqrt(var + ε);
   inv = rstd·γ; shift = β − mean·inv; the running statistics of group 0
   (decay ``momentum``, the unbiased variance n/(n−1)). Under a mesh it runs
   twice: [mean, mean2] go through :func:`parallel.mesh.all_reduce_sum`
   between the two launches, and the second divides by the ranks; with one
   rank the numbers are those of the one launch.
3. ``apply``: act(x·inv + shift) in float32, rounded once to the output.

Backward (three launches): Σg and Σg·x per group (g = dy through the
activation, whose slope comes from the pre-activation value recomputed from
x); then dγ = Σg·x̂, dβ = Σg (x̂ = (x − mean)·rstd) and the gradients with
respect to mean and mean2; then dx = g·inv + dmean/n + x·2·dmean2/n, which
is inv·(g − Σg/n − x̂·Σg·x̂/n): the gradient of the forward's graph through
mean and mean2, zero through a variance the clip holds at 0, evaluated in
that graph's order (autograd's, and the JAX package's), so that the CPU
trajectories keep to the JAX package's round-off. Under a mesh dmean and
dmean2 are all-reduced, as the forward's statistics are. Eval mode applies
the running statistics (one launch) and differentiates as x·inv + shift.

``groups > 1`` (torch DataParallel emulated): contiguous batch groups with
statistics of their own, group 0's kept; with ``group0_mesh`` group 0 lies
on that mesh's rank 0 and its statistics are broadcast from there.

- On CUDA tensors the kernels run or the call raises. They read x as
  (rows, C) with its channels contiguous (:func:`layout`): an (N, C) map or
  a channels-last one, which is what the step's convolutions give; any
  other x (contiguous NCHW, say) is copied to channels-last first, and the
  output and the gradient keep the copy's strides. Where a row is a whole
  number of 16-byte vectors and every tensor 16-byte aligned, the passes
  stream through a shared-memory ring filled by bulk copies, one block an
  SM (:func:`plan` sizes it from the shape and the card); otherwise they
  read one element an access.
- On CPU tensors the same passes run in plain PyTorch (:class:`Plain`), so
  the CPU tests hold the formulas, the mesh's all-reduce and the groups
  against the JAX package.

``launches`` counts calls that ran the kernels, forward and backward each
one, whatever number of kernels a call starts; ``path_launches`` splits
them into train mode (``rows``) and eval mode (``eval``), and counts apart
(not again in ``launches``) the calls of either mode whose activation is
Swish (``swish``), the calls whose passes all took the ring (``ring``), and
the copies a call made before its passes (``copies``: x to channels-last,
dy to x's strides), bytes that no pass counts. While a CUDA graph is
captured on a stream under :func:`capture_scope`, calls on that stream (the
backward's too, which runs on autograd's thread) record their launches in
the scope's counter instead, and each replay adds them (:func:`replayed`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from ..parallel.mesh import all_reduce_sum, broadcast_
from .fused_linear import LEAKY_SLOPE

ACTIVATIONS = {"none": 0, "relu": 1, "leaky_relu": 2, "swish": 3}
# path_launches keys that count calls (``launches`` sums them); ``swish``
# counts the Swish calls among them
PATHS = ("rows", "eval")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements of one 16-byte access
VECTOR = {torch.float32: 4, torch.bfloat16: 8}
# rows of the (PARAM_ROWS, groups, C) float32 block the finalize writes
# (csrc/batchnorm.cu P_*); LIVE is 1 where the variance was not clipped
MEAN, VAR, RSTD, INV, SHIFT, LIVE = range(6)
PARAM_ROWS = 6
FWD_STATS, GRAD_STATS, FWD_APPLY, GRAD_APPLY = range(4)
FIN_SUM, FIN_NORM = 1, 2
# passes that walk their block's stages last to first: the second of each
# direction, whose first stages then read what the first left in the L2
REVERSED = (FWD_APPLY, GRAD_APPLY)
# The ring (csrc/batchnorm.cu MAX_CONSUMERS, MAX_STAGES, BAR_BYTES,
# SMEM_BYTES): at most MAX_CONSUMERS consumer threads a block beside its
# producer warp, a whole number of lanes of the tile's 16-byte columns, at
# most MAX_COLS columns a tile, C cut into more tiles where that keeps at
# least MIN_CONSUMERS busy; stages of about STAGE_BYTES of each tensor,
# as many as RING_BYTES holds, at most MAX_STAGES. A block has at least one
# stage of rows, so small calls spread over fewer blocks.
MAX_CONSUMERS = 512
MIN_CONSUMERS = 448
MAX_COLS = 256
MAX_STAGES = 16
STAGE_BYTES = 32 * 1024
RING_BYTES = 192 * 1024
BAR_BYTES = 2 * MAX_STAGES * 8
SMEM_BYTES = 227 * 1024
# one element an access (odd shapes): a launch aims at TARGET_BLOCKS blocks
# of 256 threads, each thread with at least UNROLL rows and each block at
# least MIN_ROWS, so that its row of partials (two floats a channel of its
# tile) is at most an eighth of the bf16 it reads
THREADS = 256
TARGET_BLOCKS = 2 * 132
UNROLL = 8
MIN_ROWS = 32
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


def _count(path: str, stream: int, activation: str = "none",
           ring: bool = False, copies: int = 0) -> None:
    global launches
    rec = _recording.get(stream)
    if rec is None:
        launches += 1
        rec = path_launches
    rec[path] += 1
    for key, on in (("swish", activation == "swish"), ("ring", ring)):
        if on:
            rec[key] += 1
    if copies:
        rec["copies"] += copies


class Layout(NamedTuple):
    """x as the kernels read it: N·spatial rows of ``channels`` contiguous
    values."""
    rows: int
    channels: int


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """x (N, C, ...) with its channels contiguous: x's logical shape over
    an (N, ..., C) contiguous block."""
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


def layout(x: torch.Tensor) -> Optional[Layout]:
    """(rows, C) when x's channels are contiguous (an (N, C) map, a
    channels-last one), else None: the kernels then take a copy."""
    if not x.movedim(1, -1).is_contiguous():
        return None
    return Layout(x.numel() // x.shape[1], x.shape[1])


def _lanes(cols: int) -> int:
    """Rows side by side for ``cols`` columns: as many as MAX_CONSUMERS
    holds, whole warps where a count of lanes gives them."""
    lanes = MAX_CONSUMERS // cols
    whole = [n for n in range(lanes, 0, -1) if n * cols % 32 == 0]
    return whole[0] if whole and 2 * whole[0] >= lanes else lanes


class Plan(NamedTuple):
    """How a pass walks (rows, C): ``splits`` blocks a group and channel
    tile, each on a contiguous row range, ``tiles`` channel tiles of
    ``cols`` accesses, ``lanes`` rows side by side. ``rows`` rows a stage of
    the ring and ``stages`` stages; 0 for one element an access."""
    splits: int
    tiles: int
    cols: int
    lanes: int
    rows: int
    stages: int

    @property
    def threads(self) -> int:
        """The block: whole consumer warps, then the producer warp (the
        rows kernels: 256)."""
        if not self.stages:
            return THREADS
        return 32 * -(-self.cols * self.lanes // 32) + 32

    def smem(self, tensors: int, vec: int) -> int:
        """The ring's dynamic shared memory (csrc/batchnorm.cu ring_smem):
        the barriers, then the larger of the stages and the stats passes'
        lane sums."""
        ring = self.stages * tensors * self.rows * self.cols * 16
        red = (self.threads - 32) * 2 * vec * 4
        return BAR_BYTES + max(ring, red)


@functools.lru_cache(maxsize=512)
def plan(lay: Layout, groups: int, vec: int, tensors: int = 1,
         sms: int = H100_SMS) -> Plan:
    """The walk of a pass over ``lay`` cut into ``groups`` for ``vec``
    elements an access (1, or a 16-byte vector's: the ring), streaming
    ``tensors`` inputs (x; x and dy backward) on a card of ``sms`` SMs. The
    two passes of a direction take the same plan."""
    per = lay.rows // groups
    vpr = lay.channels // vec
    if vec == 1:
        cols = min(vpr, THREADS)
        tiles = -(-vpr // cols)
        least = max(MIN_ROWS, THREADS // cols * UNROLL)
        want = -(-TARGET_BLOCKS // (groups * tiles))
        return Plan(max(1, min(want, per // least)), tiles, cols,
                    THREADS // cols, 0, 0)
    # equal tiles of at most MAX_COLS columns, the fewest that keep
    # MIN_CONSUMERS threads busy (else the most busy)
    shapes = [(vpr // t, _lanes(vpr // t)) for t in range(1, vpr + 1)
              if vpr % t == 0 and vpr // t <= MAX_COLS]
    cols, lanes = next((s for s in shapes if s[0] * s[1] >= MIN_CONSUMERS),
                       max(shapes, key=lambda s: s[0] * s[1]))
    tiles = vpr // cols
    row_bytes = cols * 16
    rows = lanes * max(1, STAGE_BYTES // (lanes * row_bytes))
    splits = max(1, min(sms // (groups * tiles), per // rows))
    block_rows = -(-per // splits)
    chunks = -(-block_rows // rows)  # stages a block walks
    stages = max(1, min(MAX_STAGES, chunks,
                        RING_BYTES // (tensors * rows * row_bytes)))
    return Plan(splits, tiles, cols, lanes, rows, stages)


def _activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.where(z < 0, 0.0, z)
    if activation == "leaky_relu":
        return torch.where(z > 0, z, z * LEAKY_SLOPE)
    if activation == "swish":
        return z * torch.sigmoid(z)
    return z


def _slope(z: torch.Tensor, activation: str):
    if activation == "relu":
        return (z > 0).float()
    if activation == "leaky_relu":
        return torch.where(z > 0, 1.0, LEAKY_SLOPE)
    if activation == "swish":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    return 1.0


def _bessel(n: int) -> float:
    return n / (n - 1) if n > 1 else 1.0


class Plain:
    """The kernels' passes in plain PyTorch, on x's logical shape: float32
    throughout, one rounding to the output. Partials are one row a group."""

    @staticmethod
    def _view(t: torch.Tensor, groups: int) -> torch.Tensor:
        """(groups, N/groups, C, rest) float32."""
        return t.float().reshape(groups, t.shape[0] // groups, t.shape[1],
                                 -1)

    @staticmethod
    def _col(p: torch.Tensor) -> torch.Tensor:
        """(groups, C) broadcast against :meth:`_view`."""
        return p[:, None, :, None]

    @staticmethod
    def stats(x, lay, groups, pl):
        xg = Plain._view(x, groups)
        return torch.stack([xg.sum((1, 3)), xg.square().sum((1, 3))], 1)

    @staticmethod
    def finalize(partials, splits, groups, count, mode, stats, ranks,
                 weight, bias, eps, running_mean, running_var, keep, take,
                 bessel, update):
        if mode & FIN_SUM:
            c = partials.shape[-1]
            st = partials.view(groups, splits, 2, c).sum(1) / count
            if not mode & FIN_NORM:
                return st
        else:
            st = stats
        st = st / ranks
        mean, mean2 = st[:, 0], st[:, 1]
        raw = mean2 - mean.square()
        live = raw >= 0
        var = torch.where(live, raw, 0.0)
        rstd = torch.rsqrt(var + eps)
        inv = rstd * weight
        params = torch.stack([mean, var, rstd, inv, bias - mean * inv,
                              live.float()])
        if update:
            _update_running(running_mean, running_var, mean[0], var[0],
                            keep, take, bessel)
        return params

    @staticmethod
    def apply(x, lay, groups, pl, params, activation, out,
              running=None, eps=0.0):
        xg = Plain._view(x, groups)
        if running is None:
            inv, shift = Plain._col(params[INV]), Plain._col(params[SHIFT])
        else:
            rm, rv, w, b = running
            inv = torch.rsqrt(rv + eps) * w
            shift = Plain._col((b - rm * inv)[None])
            inv = Plain._col(inv[None])
        y = _activate(xg * inv + shift, activation)
        out.copy_(y.reshape(x.shape))
        return out

    @staticmethod
    def grad_stats(x, dy, lay, groups, pl, params, activation):
        xg, gr = Plain._grad_terms(x, dy, groups, params, activation)
        return torch.stack([gr.sum((1, 3)), (gr * xg).sum((1, 3))], 1)

    @staticmethod
    def _grad_terms(x, dy, groups, params, activation):
        xg = Plain._view(x, groups)
        z = xg * Plain._col(params[INV]) + Plain._col(params[SHIFT])
        return xg, Plain._view(dy, groups) * _slope(z, activation)

    @staticmethod
    def grad_finalize(partials, splits, groups, params, weight, ranks,
                      centered):
        c = partials.shape[-1]
        sums = partials.view(groups, splits, 2, c).sum(1)
        sg, sgx = sums[:, 0], sums[:, 1]
        mean, rstd = params[MEAN], params[RSTD]
        dinv = sgx - sg * mean
        dgamma, dbeta = (dinv * rstd).sum(0), sg.sum(0)
        if not centered:
            return torch.zeros_like(sums), dgamma, dbeta
        dvar = torch.where(params[LIVE] != 0,
                           -0.5 * (dinv * weight) * (rstd * rstd * rstd), 0.0)
        dmean = -(sg * params[INV]) - dvar * (2.0 * mean)
        return torch.stack([dmean, dvar], 1) / ranks, dgamma, dbeta

    @staticmethod
    def grad_apply(x, dy, lay, groups, pl, params, coef, count,
                   centered, activation, out):
        xg, gr = Plain._grad_terms(x, dy, groups, params, activation)
        dx = gr * Plain._col(params[INV])
        if centered:
            k1 = Plain._col(coef[:, 0] / count)
            k2 = Plain._col(2.0 * (coef[:, 1] / count))
            dx = dx + k1 + xg * k2
        out.copy_(dx.reshape(x.shape))
        return out


_lib_handle = None
_ready: set = set()  # devices whose ring kernels may take SMEM_BYTES


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from . import _build

        lib = _build.load("batchnorm")
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        lib.dmt_bn_pass.argtypes = [i, vp, vp, vp, i, ll] + [i] * 8 + \
            [vp] * 7 + [f, f, i, i, vp]
        lib.dmt_bn_finalize.argtypes = [vp] * 7 + [i] * 5 + [f] * 6 + [vp]
        lib.dmt_bn_grad_finalize.argtypes = [vp] * 6 + [i] * 3 + [f, i, vp]
        lib.dmt_bn_init.argtypes = []
        for fn in (lib.dmt_bn_pass, lib.dmt_bn_finalize,
                   lib.dmt_bn_grad_finalize, lib.dmt_bn_init):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _device_lib(device: torch.device):
    """The library, its ring kernels allowed their shared memory on
    ``device`` (the current device): once a device, at its first call,
    which the port makes eagerly before any capture."""
    lib = _lib()
    if device.index not in _ready:
        _check(lib.dmt_bn_init(), "init")
        _ready.add(device.index)
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"batchnorm {what} launch failed: code {err}")


class Kernel:
    """The passes as launches of ``csrc/batchnorm.cu`` on the current
    stream of x's device, walking x as the call's :class:`Plan` says; ``vec``
    1 takes the ring (16-byte accesses), 0 one element an access with the
    same blocks."""

    @staticmethod
    def _pass(kind, x, dy, out, lay, groups, pl, vec, params=None,
              coef=None, partials=None, running=None, eps=0.0, count=0.0,
              centered=0, activation="none"):
        rm, rv, w, b = running if running is not None else (None,) * 4
        ring = (pl.tiles, pl.lanes, pl.rows, pl.stages,
                int(kind in REVERSED)) if vec else (0,) * 5
        with torch.cuda.device(x.device):
            err = _device_lib(x.device).dmt_bn_pass(
                kind, x.data_ptr(), _ptr(dy), _ptr(out),
                _DTYPE_CODES[x.dtype], lay.rows, lay.channels, groups,
                pl.splits, *ring, _ptr(params),
                _ptr(coef), _ptr(partials), _ptr(rm), _ptr(rv), _ptr(w),
                _ptr(b), eps, count, centered, ACTIVATIONS[activation],
                _stream(x))
        _check(err, f"pass {kind} ({lay}, groups {groups}, {pl}, vec {vec})")

    @staticmethod
    def stats(x, lay, groups, pl, vec=1):
        partials = x.new_empty((groups * pl.splits, 2, lay.channels),
                               dtype=torch.float32)
        Kernel._pass(FWD_STATS, x, None, None, lay, groups, pl, vec,
                     partials=partials)
        return partials

    @staticmethod
    def finalize(partials, splits, groups, count, mode, stats, ranks,
                 weight, bias, eps, running_mean, running_var, keep, take,
                 bessel, update):
        c = weight.shape[0]
        if mode & FIN_NORM:
            out = weight.new_empty((PARAM_ROWS, groups, c))
        else:
            out = stats = weight.new_empty((groups, 2, c))
        with torch.cuda.device(weight.device):
            err = _lib().dmt_bn_finalize(
                _ptr(partials), _ptr(stats), _ptr(out if mode & FIN_NORM
                                                  else None),
                weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
                running_var.data_ptr(), splits, groups, c, mode, int(update),
                count, ranks, eps, keep, take, bessel, _stream(weight))
        _check(err, "finalize")
        return out

    @staticmethod
    def apply(x, lay, groups, pl, params, activation, out, running=None,
              eps=0.0, vec=1):
        Kernel._pass(FWD_APPLY, x, None, out, lay, groups, pl, vec,
                     params=params, running=running, eps=eps,
                     activation=activation)
        return out

    @staticmethod
    def grad_stats(x, dy, lay, groups, pl, params, activation, vec=1):
        partials = x.new_empty((groups * pl.splits, 2, lay.channels),
                               dtype=torch.float32)
        Kernel._pass(GRAD_STATS, x, dy, None, lay, groups, pl, vec,
                     params=params, partials=partials, activation=activation)
        return partials

    @staticmethod
    def grad_finalize(partials, splits, groups, params, weight, ranks,
                      centered):
        c = partials.shape[-1]
        coef = partials.new_empty((groups, 2, c))
        dgamma, dbeta = partials.new_empty(c), partials.new_empty(c)
        with torch.cuda.device(partials.device):
            err = _lib().dmt_bn_grad_finalize(
                partials.data_ptr(), params.data_ptr(), weight.data_ptr(),
                coef.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), splits,
                groups, c, ranks, int(centered), _stream(partials))
        _check(err, "grad finalize")
        return coef, dgamma, dbeta

    @staticmethod
    def grad_apply(x, dy, lay, groups, pl, params, coef, count,
                   centered, activation, out, vec=1):
        Kernel._pass(GRAD_APPLY, x, dy, out, lay, groups, pl, vec,
                     params=params, coef=coef, count=count,
                     centered=int(centered), activation=activation)
        return out


def _update_running(running_mean, running_var, mean, var, keep, take,
                    bessel) -> None:
    with torch.no_grad():
        running_mean.copy_(keep * running_mean + take * mean)
        running_var.copy_(keep * running_var + (take * var) * bessel)


class Options(NamedTuple):
    train: bool
    groups: int         # this rank's batch groups (train mode)
    momentum: float
    epsilon: float
    activation: str
    mesh: object        # statistics over this mesh's global batch, or None
    group0_mesh: object  # groups: group 0 on this mesh's rank 0, or None
    plain: bool         # the plain passes, on any device


# the plain passes' one row of partials a group
_PLAIN = Plan(1, 1, 1, 1, 0, 0)


class _Call:
    """One call's engine and layout, and the walk of its passes."""

    def __init__(self, x: torch.Tensor, groups: int, plain: bool):
        self.cuda = x.is_cuda and not plain
        self.ops = Kernel if self.cuda else Plain
        self.lay = layout(x) if self.cuda else None
        v = VECTOR[x.dtype]
        self.vector = v if self.cuda and self.lay.channels % v == 0 else 1
        self.sms = _sms(x.device.index) if self.cuda else H100_SMS
        self.groups = groups
        self.count = x.numel() // (x.shape[1] * groups)

    def plan(self, tensors: int) -> Plan:
        """The walk of one direction's passes, which stream ``tensors``
        inputs."""
        if not self.cuda:
            return _PLAIN
        return plan(self.lay, self.groups, self.vector, tensors, self.sms)

    def aligned(self, *tensors) -> dict:
        """Keyword arguments for the kernel's access width, checked on
        every tensor the direction's passes touch: 16-byte vectors through
        the ring where each is 16-byte aligned."""
        if not self.cuda:
            return {}
        return {"vec": int(self.vector > 1 and all(t.data_ptr() % 16 == 0
                                                   for t in tensors))}


def _forward(x, weight, bias, running_mean, running_var, o: Options,
             keep_params: bool):
    """(y, x as the kernels read it, the parameter block or None, call)."""
    copies = 0
    if x.is_cuda and not o.plain and layout(x) is None:
        x, copies = _channels_last(x), 1
    if o.train and x.shape[0] % o.groups:
        raise ValueError(f"bn_groups={o.groups} must divide the batch "
                         f"({x.shape[0]})")
    call = _Call(x, o.groups if o.train else 1, o.plain)
    ops, lay, g, pl = call.ops, call.lay, call.groups, call.plan(1)
    y = torch.empty_like(x)
    vec = call.aligned(x, y)
    if not o.train:
        running = (running_mean, running_var, weight, bias)
        ops.apply(x, lay, 1, pl, None, o.activation, y, running=running,
                  eps=o.epsilon, **vec)
        params = None
        if keep_params:
            rstd = torch.rsqrt(running_var + o.epsilon)
            inv = rstd * weight
            params = torch.stack([running_mean, running_var, rstd, inv,
                                  bias - running_mean * inv,
                                  torch.zeros_like(inv)])[:, None]
        if call.cuda:
            _count("eval", _stream(x), o.activation, vec["vec"], copies)
        return y, x, params, call
    keep, take = o.momentum, 1.0 - o.momentum
    partials = ops.stats(x, lay, g, pl, **vec)
    fin = dict(weight=weight, bias=bias, eps=o.epsilon,
               running_mean=running_mean, running_var=running_var, keep=keep,
               take=take)
    mesh = o.mesh
    if mesh is not None:
        stats = ops.finalize(partials, pl.splits, g, call.count, FIN_SUM,
                             None, 1.0, bessel=0.0, update=False, **fin)
        stats = all_reduce_sum(stats, mesh)
        params = ops.finalize(None, pl.splits, g, call.count, FIN_NORM,
                              stats, float(mesh.size),
                              bessel=_bessel(call.count * mesh.size),
                              update=True, **fin)
    else:
        params = ops.finalize(partials, pl.splits, g, call.count,
                              FIN_SUM | FIN_NORM, None, 1.0,
                              bessel=_bessel(call.count),
                              update=o.group0_mesh is None, **fin)
        if o.group0_mesh is not None:
            first = params[MEAN:VAR + 1, 0].clone()
            broadcast_([first], o.group0_mesh, 0)
            _update_running(running_mean, running_var, first[0], first[1],
                            keep, take, _bessel(call.count))
    ops.apply(x, lay, g, pl, params, o.activation, y, **vec)
    if call.cuda:
        _count("rows", _stream(x), o.activation, vec["vec"], copies)
    return y, x, params, call


def _backward(x, weight, dy, params, call: _Call, o: Options,
              need_dx: bool):
    """(dx or None, dγ, dβ)."""
    ops, lay, g, pl = call.ops, call.lay, call.groups, call.plan(2)
    copies = 0
    if call.cuda and dy.stride() != x.stride():
        dy, copies = torch.empty_like(x).copy_(dy), 1
    dx = torch.empty_like(x) if need_dx else None
    vec = call.aligned(*(t for t in (x, dy, dx) if t is not None))
    partials = ops.grad_stats(x, dy, lay, g, pl, params, o.activation, **vec)
    mesh = o.mesh if o.train else None
    ranks = float(mesh.size) if mesh is not None else 1.0
    coef, dgamma, dbeta = ops.grad_finalize(partials, pl.splits, g, params,
                                            weight, ranks, o.train)
    if mesh is not None:
        coef = all_reduce_sum(coef, mesh)
    if need_dx:
        ops.grad_apply(x, dy, lay, g, pl, params, coef, float(call.count),
                       o.train, o.activation, dx, **vec)
    if call.cuda:
        _count("rows" if o.train else "eval", _stream(x), o.activation,
               vec["vec"], copies)
    return dx, dgamma, dbeta


class BatchNormFunction(torch.autograd.Function):
    """Forward through the passes; backward the explicit formula. Saves x,
    the parameter block (mean, var, rstd, inv, shift, the clip's mask) and
    nothing of the output."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, o):
        y, xs, params, call = _forward(x, weight, bias, running_mean,
                                       running_var, o, keep_params=True)
        ctx.o, ctx.call = o, call
        ctx.save_for_backward(xs, weight, params)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, params = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(x, weight, dy, params, ctx.call, ctx.o,
                                      ctx.needs_input_grad[0])
        return (dx, dgamma if ctx.needs_input_grad[1] else None,
                dbeta if ctx.needs_input_grad[2] else None, None, None, None)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, groups: int = 1, momentum: float = 0.9,
               epsilon: float = 1e-5, activation: str = "none",
               out_dtype: Optional[torch.dtype] = None, mesh=None,
               group0_mesh=None) -> torch.Tensor:
    """act(BatchNorm(x)) in ``out_dtype`` (default x's): the kernels for
    CUDA tensors, the plain passes for CPU tensors; differentiable in x, γ
    and β. Train mode updates the running statistics in place. ``groups``
    is this rank's batch groups; ``mesh`` takes the statistics over a mesh's
    global batch, ``group0_mesh`` broadcasts group 0's from its rank 0."""
    return _batch_norm(x, weight, bias, running_mean, running_var, train,
                       groups, momentum, epsilon, activation, out_dtype,
                       mesh, group0_mesh, plain=False)


def batch_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, *, train: bool,
                     groups: int = 1, momentum: float = 0.9,
                     epsilon: float = 1e-5, activation: str = "none",
                     out_dtype: Optional[torch.dtype] = None, mesh=None,
                     group0_mesh=None) -> torch.Tensor:
    """:func:`batch_norm` through the plain passes on any device: what the
    card's tests and ``chip_smoke.py`` hold the kernels against."""
    return _batch_norm(x, weight, bias, running_mean, running_var, train,
                       groups, momentum, epsilon, activation, out_dtype,
                       mesh, group0_mesh, plain=True)


def _batch_norm(x, weight, bias, running_mean, running_var, train, groups,
                momentum, epsilon, activation, out_dtype, mesh, group0_mesh,
                plain):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.dim() < 2:
        raise ValueError(f"batch_norm: x must be (N, C, ...), got shape "
                         f"{tuple(x.shape)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"batch_norm computes in float32 or bfloat16, not "
                        f"{out_dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batch_norm: unsupported device {x.device}")
    for t in (weight, bias, running_mean, running_var):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("batch_norm: γ, β and the running statistics "
                             "must be float32 on x's device")
    if mesh is not None and groups > 1:
        raise ValueError("batch_norm: grouped statistics stay on their "
                         "rank; pass the mesh as group0_mesh")
    x = x.to(out_dtype)
    o = Options(train, groups, momentum, epsilon, activation, mesh,
                group0_mesh, plain)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return BatchNormFunction.apply(x, weight, bias, running_mean,
                                       running_var, o)
    return _forward(x, weight, bias, running_mean, running_var, o,
                    keep_params=False)[0]
