"""The port's BatchNorm passes (disentangle_mlp_tpu_torch/ops/batchnorm.py,
csrc/batchnorm.cu) without JAX: the layout and plan the kernels take, the
launch counts of a graph's capture and replays, the plain passes against
autograd of the forward's graph in float64, and, on the card, the kernels
against the plain passes at the β-VAE-GAN step's shapes. The JAX package
holds the plain passes in tests/test_torch_port_models.py. This file
imports no JAX, so its card tests run on the GPU machine:

    python -m pytest tests/test_torch_port_batchnorm.py -m cuda -q

Card tolerances, bf16 (both sides compute in float32 and round once, and
round each product and sum alike; only the order of the float32 sums
differs, by about 1e-6 of a statistic):
- y and dx: one bf16 step (2^-7 of the value) where a statistic's last
  bits move the rounding, plus 1e-4 of the largest |dx|, where dx's three
  terms cancel; dx is not compared within 1e-4 of the activation's kink
  (|pre-activation| < 1e-4, some 1e-4 of the elements; the two sides'
  pre-activations differ by about 1e-6), where either slope may be taken.
- dγ, dβ: 1e-3 of the largest, sums of a million terms that cancel.
- the running statistics: 1e-5 relative, float32 rounding of the sums.
"""

import collections
import math

import pytest
import torch

from disentangle_mlp_tpu_torch.ops import batchnorm as bn

# (shape, activation, forward / backward calls a β-VAE-GAN step): every
# BatchNorm input of the step at batch 256, NCHW logical shapes
STEP_SHAPES = [
    ((256, 64, 32, 32), "relu", 2, 2),       # encoder bn1
    ((256, 128, 16, 16), "relu", 2, 2),      # encoder bn2
    ((256, 256, 8, 8), "relu", 2, 2),        # encoder bn3
    ((256, 2048), "relu", 4, 4),             # encoder mu_bn, lv_bn
    ((256, 16384), "relu", 3, 3),            # decoder pre_bn
    ((256, 256, 16, 16), "relu", 3, 3),      # decoder dbn1
    ((256, 128, 32, 32), "relu", 3, 3),      # decoder dbn2
    ((256, 32, 64, 64), "relu", 3, 3),       # decoder dbn3
    ((256, 32, 64, 64), "leaky_relu", 5, 4),   # discriminator bn1
    ((256, 128, 32, 32), "leaky_relu", 5, 4),  # discriminator bn2
    ((256, 256, 16, 16), "leaky_relu", 5, 4),  # discriminator bn3
    ((256, 256, 8, 8), "leaky_relu", 5, 4),    # discriminator bn4
]
BF16_STEP = 2.0 ** -7
DX_CANCEL = 1e-4
KINK = 1e-4
SUM_REL = 1e-3
STATS_REL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with -m cuda on the GPU machine")


def _params(c, device, seed):
    g = torch.Generator().manual_seed(seed)
    w = 1.0 + 0.1 * torch.randn(c, generator=g)
    b = 0.1 * torch.randn(c, generator=g)
    rm = 0.1 * torch.randn(c, generator=g)
    rv = 0.5 + torch.rand(c, generator=g)
    return [t.to(device) for t in (w, b, rm, rv)]


def _input(shape, device, seed, dtype, channels_last):
    """x with a mean and a spread of its own in every channel."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    per = (1, c) + (1,) * (len(shape) - 2)
    loc = torch.randn(per, generator=g, device=device)
    scale = 0.5 + torch.rand(per, generator=g, device=device)
    x = (torch.randn(shape, generator=g, device=device) * scale + loc)
    x = x.to(dtype)
    if channels_last and x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


# ---------------------------------------------------------------- layout --

def test_layout_follows_the_strides():
    """(rows, C) where the channels are contiguous; any other x is copied
    to channels-last, which the kernels then take."""
    nchw = torch.arange(4 * 6 * 3 * 5.0).reshape(4, 6, 3, 5)
    assert bn.layout(nchw) is None
    nhwc = nchw.contiguous(memory_format=torch.channels_last)
    assert bn.layout(nhwc) == bn.Layout(60, 6)
    assert bn.layout(torch.empty(4, 6)) == bn.Layout(4, 6)
    assert bn.layout(torch.empty(4, 6, 1, 1)) == bn.Layout(4, 6)
    assert bn.layout(torch.empty(4, 6, 7)) is None
    assert bn.layout(torch.empty(6, 4).t()) is None
    assert bn.layout(nchw[:, :, :, 1:]) is None
    for x in (nchw, torch.randn(4, 6, 7), torch.randn(6, 4).t(),
              nchw[:, :, :, 1:]):
        copy = bn._channels_last(x)
        assert bn.layout(copy) == bn.Layout(x.numel() // 6, 6)
        assert torch.equal(copy, x)
        assert torch.empty_like(copy).stride() == copy.stride()


# (shape, activation, forward / backward calls a step) of NVAE's BatchNorms
# at the CelebA 64x64 widths, batch 128, NCHW logical shapes: every one of
# h100_bench/reference/nvae.py ``batchnorm_calls`` (chip_smoke.py times
# them all), the largest share of the step's bytes first
NVAE_SHAPES = [
    ((128, 768, 32, 32), "swish", 80),    # decoder cells' expansion, 32x32
    ((128, 1536, 16, 16), "swish", 40),   # decoder cells' expansion, 16x16
    ((128, 128, 32, 32), "swish", 82),    # cells at 32x32
    ((128, 128, 32, 32), "none", 81),     # cells' last BatchNorm, no activation
    ((128, 3072, 8, 8), "swish", 16),     # decoder cells' expansion, 8x8
    ((128, 1536, 32, 32), "swish", 2),
    ((128, 384, 64, 64), "swish", 2),
    ((128, 256, 16, 16), "swish", 42),
    ((128, 256, 16, 16), "none", 41),
    ((128, 3072, 16, 16), "swish", 2),
    ((128, 192, 64, 64), "swish", 2),     # the postprocess normal cell
    ((128, 64, 64, 64), "swish", 3),      # preprocess
    ((128, 64, 64, 64), "none", 3),
    ((128, 512, 8, 8), "swish", 21),
    ((128, 512, 8, 8), "none", 16),
    ((128, 128, 64, 64), "none", 1),
    ((128, 256, 32, 32), "none", 1),
    ((128, 512, 16, 16), "none", 1),
]
# the design's floor of bytes in flight on an SM while a block has that
# many rows left (csrc/batchnorm.cu, the ring)
IN_FLIGHT_FLOOR = 64 * 1024


def _layout(shape):
    x = torch.empty(shape)
    if x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    return bn.layout(x)


@pytest.mark.parametrize("shape", sorted({s[0] for s in STEP_SHAPES}
                                         | {s[0] for s in NVAE_SHAPES}))
@pytest.mark.parametrize("groups", [1, 2])
def test_plan_cuts_each_group_into_full_blocks(shape, groups):
    """The ring's walk, bf16 and float32, forward (x) and backward (x and
    dy): every consumer thread owns a column of a full channel tile, whole
    warps but the last; the ring and the lane sums fit in the shared memory
    a block may take; the bytes in flight on an SM meet the design's floor
    where the block has that many rows; each group's rows are covered once,
    by blocks of one group each, one block an SM. One element an access:
    each group's rows cut into at most as many blocks as fill the card,
    each with UNROLL rows a thread and MIN_ROWS rows at least."""
    lay = _layout(shape)
    per = lay.rows // groups
    for vec in (8, 4):
        for tensors in (1, 2):
            pl = bn.plan(lay, groups, vec, tensors)
            consumers = pl.cols * pl.lanes
            assert pl.tiles * pl.cols * vec == lay.channels, pl
            assert pl.cols <= bn.MAX_COLS, pl
            assert bn.MAX_CONSUMERS // 2 < consumers <= bn.MAX_CONSUMERS, pl
            assert 0 <= pl.threads - 32 - consumers < 32, pl
            assert pl.rows % pl.lanes == 0, pl
            assert 1 <= pl.stages <= bn.MAX_STAGES, pl
            assert pl.smem(tensors, vec) <= bn.SMEM_BYTES, pl
            assert groups * pl.splits * pl.tiles <= bn.H100_SMS, pl
            # block q of group g: rows g·per + [q·per/splits, (q+1)·per/splits)
            bounds = [q * per // pl.splits for q in range(pl.splits + 1)]
            assert bounds[0] == 0 and bounds[-1] == per
            assert all(a < b for a, b in zip(bounds, bounds[1:])), pl
            block_rows = max(b - a for a, b in zip(bounds, bounds[1:]))
            chunks = -(-block_rows // pl.rows)
            stage = tensors * pl.rows * pl.cols * 16
            assert pl.stages == min(chunks, bn.MAX_STAGES) \
                or (pl.stages - 1) * stage >= IN_FLIGHT_FLOOR, pl
    pl = bn.plan(lay, groups, 1)
    cols = min(lay.channels, bn.THREADS)
    across = groups * math.ceil(lay.channels / cols)
    least = max(bn.MIN_ROWS, bn.THREADS // cols * bn.UNROLL)
    assert pl.stages == 0 and pl.threads == bn.THREADS
    assert 1 <= pl.splits <= per
    assert pl.splits == 1 or per // pl.splits >= least
    assert pl.splits == 1 or (pl.splits - 1) * across < bn.TARGET_BLOCKS


def test_the_ring_fills_every_sm_at_nvae_sizes():
    """At NVAE's large calls one block on each of the card's SMs, every
    block with more stages than its ring holds, and the ring deep enough
    that more than the floor is in flight."""
    for shape, _, _ in NVAE_SHAPES:
        lay = _layout(shape)
        if lay.rows * lay.channels < 16 * 2 ** 20:
            continue
        for tensors in (1, 2):
            pl = bn.plan(lay, 1, 8, tensors, sms=132)
            assert pl.splits * pl.tiles == 132, (shape, pl)
            stage = tensors * pl.rows * pl.cols * 16
            assert (pl.stages - 1) * stage >= IN_FLIGHT_FLOOR, (shape, pl)
            assert lay.rows // pl.splits > pl.stages * pl.rows, (shape, pl)


# ------------------------------------------------------- counts and errors --

class _Stream:
    cuda_stream = 12345


def test_a_capture_records_and_each_replay_adds_its_launches():
    before, paths = bn.launches, collections.Counter(bn.path_launches)
    counts = collections.Counter()
    with bn.capture_scope(_Stream(), counts):
        bn._count("rows", _Stream.cuda_stream)
        bn._count("rows", _Stream.cuda_stream)
        bn._count("eval", _Stream.cuda_stream)
        bn._count("eval", 999)  # another stream counts at once
    assert counts == {"rows": 2, "eval": 1}
    assert bn.launches == before + 1
    bn.replayed(counts)
    bn.replayed(counts)
    assert bn.launches == before + 7
    assert bn.path_launches - paths == {"rows": 4, "eval": 3}
    assert _Stream.cuda_stream not in bn._recording


def test_the_plain_version_counts_no_launch():
    w, b, rm, rv = _params(6, "cpu", 0)
    before = bn.launches
    x = torch.randn(4, 6, 3, 3, requires_grad=True)
    bn.batch_norm(x, w, b, rm, rv, train=True, activation="relu").sum() \
        .backward()
    bn.batch_norm(x, w, b, rm, rv, train=False)
    assert bn.launches == before


def test_wrong_arguments_raise():
    w, b, rm, rv = _params(6, "cpu", 0)
    x = torch.randn(6, 6)
    with pytest.raises(ValueError, match="activation"):
        bn.batch_norm(x, w, b, rm, rv, train=True, activation="tanh")
    with pytest.raises(ValueError, match="must divide the batch"):
        bn.batch_norm(x, w, b, rm, rv, train=True, groups=4)
    with pytest.raises(ValueError, match="group0_mesh"):
        bn.batch_norm(x, w, b, rm, rv, train=True, groups=2, mesh=object())
    with pytest.raises(ValueError, match="float32"):
        bn.batch_norm(x, w.double(), b, rm, rv, train=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn.batch_norm(x, w, b, rm, rv, train=True, out_dtype=torch.float16)


# ------------------------------------------ plain passes against autograd --

def _graph(x, w, b, rm, rv, train, groups, activation):
    """The forward's graph in float64 torch ops, differentiated by
    autograd: E[x²]−E[x]² variance clipped at 0, rsqrt·γ folded into a
    scale and shift, then the activation; running statistics updated."""
    n, c = x.shape[:2]
    xg = x.reshape(groups, n // groups, c, -1)
    if train:
        mean = xg.mean((1, 3))
        var = torch.clamp(xg.square().mean((1, 3)) - mean.square(), min=0)
        m = xg[0].numel() // c
        with torch.no_grad():
            rm.copy_(0.9 * rm + 0.1 * mean[0])
            rv.copy_(0.9 * rv + 0.1 * var[0] * m / (m - 1))
    else:
        mean, var = rm[None], rv[None]
    inv = torch.rsqrt(var + 1e-5) * w
    shift = b - mean * inv
    z = xg * inv[:, None, :, None] + shift[:, None, :, None]
    if activation == "relu":
        z = torch.relu(z)
    elif activation == "leaky_relu":
        z = torch.nn.functional.leaky_relu(z, 0.2)
    return z.reshape(x.shape)


@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("mode", ["train", "groups2", "eval"])
@pytest.mark.parametrize("shape", [(8, 5), (8, 5, 3, 4)])
def test_plain_passes_match_autograd_of_the_graph(shape, mode, activation):
    groups, train = (2 if mode == "groups2" else 1), mode != "eval"
    w, b, rm, rv = _params(shape[1], "cpu", 1)
    x = _input(shape, "cpu", 2, torch.float32, len(shape) == 4)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    want_state = [t.double() for t in (w, b, rm, rv)]
    for t in want_state[:2]:
        t.requires_grad_()
    xd = x.double().requires_grad_()
    y_want = _graph(xd, *want_state, train, groups, activation)
    y_want.backward(dy.double())

    w.requires_grad_(), b.requires_grad_()
    xt = x.clone().requires_grad_()
    y = bn.batch_norm(xt, w, b, rm, rv, train=train, groups=groups,
                      activation=activation)
    y.backward(dy)
    for name, got, want in (("y", y, y_want), ("dx", xt.grad, xd.grad),
                            ("dγ", w.grad, want_state[0].grad),
                            ("dβ", b.grad, want_state[1].grad),
                            ("mean", rm, want_state[2]),
                            ("var", rv, want_state[3])):
        torch.testing.assert_close(got.double(), want.detach(), rtol=1e-5,
                                   atol=1e-5, msg=name)


# ------------------------------------------------------------------ swish --

@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swish_matches_autograd_of_silu_of_batch_norm(dtype, mode):
    """Swish (NVAE's BatchNorm-Swish): the plain passes against float64
    autograd of ``silu(F.batch_norm(x))`` (torch's own BatchNorm, biased
    variance, decay 0.95 as NVAE's momentum 0.05), forward and backward.
    float32 keeps the plain version's 1e-5; bf16 x and output allow one
    bf16 step of y, and dx, dγ, dβ are compared against autograd of the
    same bf16 input, with one bf16 step plus 1e-3 of the largest value
    (the gradient's terms cancel in float32 after the one rounding of y)."""
    train = mode == "train"
    shape = (16, 6, 5, 4)
    w, b, rm, rv = _params(shape[1], "cpu", 4)
    x = _input(shape, "cpu", 5, dtype, True)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(6)
                     ).to(dtype)
    wd, bd = (t.double().requires_grad_() for t in (w, b))
    rmd, rvd = rm.double(), rv.double()
    xd = x.double().requires_grad_()
    y_want = torch.nn.functional.silu(torch.nn.functional.batch_norm(
        xd, rmd, rvd, wd, bd, training=train, momentum=0.05, eps=1e-5))
    y_want.backward(dy.double())

    w.requires_grad_(), b.requires_grad_()
    xt = x.clone().requires_grad_()
    y = bn.batch_norm(xt, w, b, rm, rv, train=train, momentum=0.95,
                      activation="swish")
    y.backward(dy)
    assert y.dtype == dtype and xt.grad.dtype == dtype
    step = 1e-5 if dtype == torch.float32 else BF16_STEP
    for name, got, want in (("y", y, y_want), ("dx", xt.grad, xd.grad),
                            ("dγ", w.grad, wd.grad), ("dβ", b.grad, bd.grad),
                            ("mean", rm, rmd), ("var", rv, rvd)):
        want = want.detach()
        atol = 1e-5 if dtype == torch.float32 or name in ("mean", "var") \
            else (0 if name == "y" else 1e-3) * want.abs().max().item() \
            + 1e-6
        torch.testing.assert_close(got.double(), want, rtol=step,
                                   atol=atol, msg=name)


def test_swish_calls_are_counted_apart():
    """A Swish call counts once in ``launches`` (its mode) and once more
    under ``path_launches["swish"]``, eager and through a capture."""
    before, paths = bn.launches, collections.Counter(bn.path_launches)
    counts = collections.Counter()
    with bn.capture_scope(_Stream(), counts):
        bn._count("rows", _Stream.cuda_stream, "swish")
        bn._count("rows", _Stream.cuda_stream, "relu")
    assert counts == {"rows": 2, "swish": 1}
    bn._count("eval", 999, "swish")
    bn.replayed(counts)
    assert bn.launches == before + 3
    assert bn.path_launches - paths == {"rows": 2, "eval": 1, "swish": 2}


def test_the_ring_and_the_copies_are_counted_apart():
    """A call whose passes all took the ring counts once more under
    ``ring``, and the copies it made first under ``copies``, neither again
    in ``launches``; eager and through a capture."""
    before, paths = bn.launches, collections.Counter(bn.path_launches)
    counts = collections.Counter()
    with bn.capture_scope(_Stream(), counts):
        bn._count("rows", _Stream.cuda_stream, "swish", ring=True, copies=1)
        bn._count("rows", _Stream.cuda_stream, "none", ring=False)
    assert counts == {"rows": 2, "swish": 1, "ring": 1, "copies": 1}
    bn._count("eval", 999, "relu", ring=True)
    bn.replayed(counts)
    bn.replayed(counts)
    assert bn.launches == before + 5
    assert bn.path_launches - paths == {"rows": 4, "eval": 1, "swish": 2,
                                        "ring": 3, "copies": 2}


def test_nvae_shapes_are_the_references():
    """NVAE_SHAPES is h100_bench/reference/nvae.py's ``batchnorm_calls``
    (rows, C, activation), call for call."""
    import importlib
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "h100_bench"))
    try:
        ref = importlib.import_module("reference.nvae")
    finally:
        sys.path.pop(0)
    with open(os.path.join(root, "h100_bench", "configs",
                           "nvae_celeba64.json")) as f:
        calls = collections.Counter(ref.batchnorm_calls(json.load(f)))
    ours = {(s[0] * s[2] * s[3], s[1], a): n for s, a, n in NVAE_SHAPES}
    assert ours == dict(calls)


# ------------------------------------------------------------- the card --

def _run(fn, x, dy, state, activation, train=True, groups=1):
    w, b, rm, rv = (t.clone() for t in state)
    w.requires_grad_(), b.requires_grad_()
    xt = x.detach().clone().requires_grad_()
    y = fn(xt, w, b, rm, rv, train=train, groups=groups,
           activation=activation)
    y.backward(dy)
    return {"y": y.detach(), "dx": xt.grad, "dγ": w.grad, "dβ": b.grad,
            "mean": rm, "var": rv}


def _kink(x, state, train, groups):
    """|pre-activation| in float64, for the slope's ambiguous elements."""
    w, b, rm, rv = (t.double() for t in state)
    xd = x.double()
    n, c = x.shape[:2]
    xg = xd.reshape(groups, n // groups, c, -1)
    if train:
        mean = xg.mean((1, 3))
        var = xg.var((1, 3), unbiased=False)
    else:
        mean, var = rm[None], rv[None]
    inv = torch.rsqrt(var + 1e-5) * w
    z = (xg - mean[:, None, :, None]) * inv[:, None, :, None] \
        + b[None, None, :, None]
    return z.abs().reshape(x.shape)


def compare(got, want, x, state, train=True, groups=1):
    """The largest error of each output over its tolerance (≤ 1 passes),
    and the dx elements left out at the kink."""
    out = {}
    near = _kink(x, state, train, groups) < KINK
    for key in ("y", "dx"):
        g, w = got[key].float(), want[key].float()
        tol = BF16_STEP * w.abs() + (DX_CANCEL * w.abs().max()
                                     if key == "dx" else 1e-6)
        if got[key].dtype == torch.float32:
            tol = 1e-5 * (w.abs() + w.abs().max())
        over = (g - w).abs() / tol
        if key == "dx":
            over = torch.where(near, 0.0, over)
        out[key] = over.max().item()
    for key in ("dγ", "dβ"):
        d = (got[key] - want[key]).abs()
        out[key] = (d / (SUM_REL * (want[key].abs() + want[key].abs().max()))
                    ).max().item()
    for key in ("mean", "var"):
        d = (got[key] - want[key]).abs()
        out[key] = (d / (STATS_REL * want[key].abs() + 1e-7)).max().item()
    out["kink"] = int(near.sum())
    return out


@pytest.mark.cuda
def test_kernels_match_plain_at_the_step_shapes(card):
    """Every BatchNorm shape of the β-VAE-GAN step, bf16, train mode, its
    own activation, forward and backward, channels-last as the step gives
    them: the kernels against the plain passes on the same card tensors,
    and two launches bit-identical."""
    dev = torch.device("cuda")
    seen = set()
    for i, (shape, activation, _, _) in enumerate(STEP_SHAPES):
        if (shape, activation) in seen:
            continue
        seen.add((shape, activation))
        x = _input(shape, dev, 10 + i, torch.bfloat16, True)
        dy = _input(shape, dev, 50 + i, torch.bfloat16, True)
        state = _params(shape[1], dev, i)
        before = bn.launches
        got = _run(bn.batch_norm, x, dy, state, activation)
        assert bn.launches == before + 2
        again = _run(bn.batch_norm, x, dy, state, activation)
        want = _run(bn.batch_norm_plain, x, dy, state, activation)
        torch.cuda.synchronize()
        for key in got:
            assert torch.equal(got[key], again[key]), (shape, key)
        assert got["y"].stride() == x.stride()
        err = compare(got, want, x, state)
        assert err["kink"] <= 1e-3 * x.numel(), (shape, err)
        assert max(v for k, v in err.items() if k != "kink") <= 1, \
            (shape, activation, err)


# NVAE's shapes on the card: its Swish shapes, and no activation at the
# scales' cell widths
NVAE_CARD_SHAPES = [
    ((128, 64, 64, 64), "swish"),      # preprocess, 64x64x64
    ((128, 128, 32, 32), "swish"),     # encoder cells at 32x32
    ((128, 768, 32, 32), "swish"),     # decoder cells' expansion at 32x32
    ((128, 3072, 8, 8), "swish"),      # decoder cells' expansion at 8x8
    ((128, 192, 64, 64), "swish"),     # the postprocess normal cell
    ((128, 128, 32, 32), "none"),      # (131072, 128)
    ((128, 256, 16, 16), "none"),      # (32768, 256)
    ((128, 512, 8, 8), "none"),        # (8192, 512)
]


@pytest.mark.cuda
def test_swish_kernels_match_plain_at_nvae_shapes(card):
    """NVAE's BatchNorm-Swish, and its BatchNorms without an activation,
    bf16 channels-last, train mode: the kernels against the plain passes,
    within the step shapes' bounds, two launches bit-identical, each call
    through the ring and counted once more as Swish where it is one."""
    dev = torch.device("cuda")
    for i, (shape, act) in enumerate(NVAE_CARD_SHAPES):
        x = _input(shape, dev, 70 + i, torch.bfloat16, True)
        dy = _input(shape, dev, 90 + i, torch.bfloat16, True)
        state = _params(shape[1], dev, 30 + i)
        before = collections.Counter(bn.path_launches)
        got = _run(bn.batch_norm, x, dy, state, act)
        counts = bn.path_launches - before
        assert counts == {"rows": 2, "ring": 2, **({"swish": 2} if act
                                                    == "swish" else {})}, \
            (shape, act, counts)
        again = _run(bn.batch_norm, x, dy, state, act)
        want = _run(bn.batch_norm_plain, x, dy, state, act)
        torch.cuda.synchronize()
        for key in got:
            assert torch.equal(got[key], again[key]), (shape, key)
        err = compare(got, want, x, state)
        assert max(v for k, v in err.items() if k != "kink") <= 1, \
            (shape, act, err)


class _OneRank:
    """A process group of one: the all-reduce leaves its tensors as they
    are, as NCCL's does with one rank."""

    def allreduce(self, tensors):
        return self

    def wait(self):
        return True


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["groups2", "mesh1"])
def test_kernels_match_plain_at_nvae_width_grouped_and_meshed(card, case):
    """NVAE's widest Swish shape with the batch in two groups of their own
    statistics, and under a mesh of one rank (the forward's finalize in two
    launches around the all-reduce, the backward's coefficients
    all-reduced): the kernels against the plain passes on the same path,
    two launches bit-identical, every call through the ring."""
    import types

    dev = torch.device("cuda")
    shape = (128, 768, 32, 32)
    x = _input(shape, dev, 17, torch.bfloat16, True)
    dy = _input(shape, dev, 18, torch.bfloat16, True)
    state = _params(shape[1], dev, 19)
    groups = 2 if case == "groups2" else 1
    mesh = types.SimpleNamespace(size=1, group=_OneRank()) \
        if case == "mesh1" else None

    def run(fn):
        w, b, rm, rv = (t.clone() for t in state)
        w.requires_grad_(), b.requires_grad_()
        xt = x.detach().clone().requires_grad_()
        y = fn(xt, w, b, rm, rv, train=True, groups=groups,
               activation="swish", mesh=mesh)
        y.backward(dy)
        return {"y": y.detach(), "dx": xt.grad, "dγ": w.grad, "dβ": b.grad,
                "mean": rm, "var": rv}

    before = collections.Counter(bn.path_launches)
    got = run(bn.batch_norm)
    assert bn.path_launches - before == {"rows": 2, "ring": 2, "swish": 2}
    again = run(bn.batch_norm)
    want = run(bn.batch_norm_plain)
    torch.cuda.synchronize()
    for key in got:
        assert torch.equal(got[key], again[key]), (case, key)
    err = compare(got, want, x, state, True, groups)
    assert max(v for k, v in err.items() if k != "kink") <= 1, (case, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["groups2", "eval", "float32", "odd"])
def test_kernels_match_plain_off_the_step(card, case):
    """Grouped statistics, eval mode, float32, and a shape the 16-byte
    accesses cannot take (V = 1); channels-last, and contiguous NCHW, which
    the kernels take as a channels-last copy."""
    dev = torch.device("cuda")
    shape = (10, 6, 5, 7) if case == "odd" else (64, 32, 16, 16)
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    groups, train = (2 if case == "groups2" else 1), case != "eval"
    for channels_last in (True, False):
        x = _input(shape, dev, 7, dtype, channels_last)
        dy = _input(shape, dev, 8, dtype, channels_last)
        state = _params(shape[1], dev, 9)
        kw = dict(train=train, groups=groups)
        got = _run(bn.batch_norm, x, dy, state, "leaky_relu", **kw)
        want = _run(bn.batch_norm_plain, x, dy, state, "leaky_relu", **kw)
        err = compare(got, want, x, state, train, groups)
        assert max(v for k, v in err.items() if k != "kink") <= 1, \
            (case, channels_last, err)
