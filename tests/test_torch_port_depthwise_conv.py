"""The port's depthwise convolution (disentangle_mlp_tpu_torch/ops/
depthwise_conv.py, csrc/depthwise_conv.cu) without JAX: the plain version
against float64 ``F.conv2d``, the kernels' walk (tiles, halo boxes, turned
weights, dw rows and their finalize) replayed in numpy, the plan at NVAE's
shapes, the rule a convolution takes the kernels by, the launch counts of a
graph's capture and replays, the wrapper's refusals, and, on the card, the
kernels against the plain version. This file imports no JAX, so its card
tests run on the GPU machine:

    python -m pytest tests/test_torch_port_depthwise_conv.py -m cuda -q

Card tolerances (both sides add the same float32 products; only the order
of the sums, and the kernels' fused multiply-adds, differ):
- float32: y and dx 1e-5 of the largest |value|, dw 1e-4 of the largest
  (sums of N·H·W products that cancel).
- bf16: y and dx one bf16 step (2^-7 of the value) where the float32 sums'
  last bits move the rounding, plus 1e-5 of the largest; dw, rounded once
  from float32 sums, the same.
"""

import collections
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disentangle_mlp_tpu_torch.ops import depthwise_conv as dwc

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
NVAE_CONFIG = BENCH / "configs" / "nvae_celeba64.json"
# (C, H, W, calls a step) of NVAE's depthwise 5×5 at batch 128, from
# h100_bench/reference/nvae.py's layer table
NVAE_SHAPES = [(768, 32, 32, 40), (1536, 16, 16, 20), (3072, 8, 8, 8),
               (3072, 16, 16, 1), (1536, 32, 32, 1), (384, 64, 64, 1),
               (192, 64, 64, 1)]
NVAE_BATCH = 128
SCRATCH_BYTES = 4 * 2 ** 20
BF16_STEP = 2.0 ** -7
TOL = {torch.float32: {"y": 1e-5, "dx": 1e-5, "dw": 1e-4},
       torch.bfloat16: {"y": 1e-5, "dx": 1e-5, "dw": 1e-5}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with -m cuda on the GPU machine")


def _tensors(shape, k, seed, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    w = torch.randn((shape[1], 1, k, k), generator=g, dtype=torch.float64)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype) for t in (x, w, dy)]


def _want(x, w, dy):
    """y, dx, dw of float64 F.conv2d (groups = C)."""
    x, w = (t.detach().double().requires_grad_() for t in (x, w))
    y = F.conv2d(x, w, None, 1, (w.shape[-1] - 1) // 2, 1, x.shape[1])
    dx, dw = torch.autograd.grad(y, (x, w), dy.double())
    return y.detach(), dx, dw


# ------------------------------------------------------ the plain version --

SHAPES = [((2, 16, 8, 8), 5),     # the halo wider than a quarter of 8×8
          ((3, 8, 7, 9), 3),      # odd H ≠ W
          ((2, 8, 7, 9), 5),
          ((1, 24, 5, 11), 3),
          ((2, 4, 3, 3), 5)]      # the kernel wider than the image


@pytest.mark.parametrize("shape,k", SHAPES)
def test_the_plain_version_matches_float64_conv2d(shape, k):
    x, w, dy = _tensors(shape, k, sum(shape) + k)
    y = dwc.Plain.conv(x, w)
    dx, dw = dwc.Plain.backward(x.float(), w.float(), dy.float())
    want = _want(x, w, dy)
    for got, ref in zip((y, dx, dw), want):
        assert got.shape == ref.shape
        torch.testing.assert_close(got.double(), ref, rtol=0, atol=2e-5 * max(
            1.0, float(ref.abs().max())))


@pytest.mark.parametrize("shape,k", SHAPES[:3])
def test_autograd_through_the_function_on_the_cpu(shape, k):
    x, w, dy = _tensors(shape, k, 7, torch.float32)
    x.requires_grad_(), w.requires_grad_()
    before = dwc.launches
    y = dwc.depthwise_conv(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert dwc.launches == before  # the plain version launches nothing
    for got, ref in zip((y, dx, dw), _want(x, w, dy)):
        torch.testing.assert_close(got.double(), ref, rtol=0, atol=2e-5 * max(
            1.0, float(ref.abs().max())))


def test_bf16_rounds_once_from_float32_sums():
    x, w, dy = _tensors((2, 16, 6, 6), 5, 3, torch.bfloat16)
    y = dwc.Plain.forward(x, w)
    dx, dw = dwc.Plain.backward(x, w, dy)
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(y, dwc.Plain.conv(x, w).to(torch.bfloat16))
    assert torch.equal(dx, dwc.Plain.conv(dy, w.flip(-2, -1))
                       .to(torch.bfloat16))


# --------------------------------------------------- the kernels' walk ----

def _items(pl, backward):
    """Runs of RUN outputs (FWD_ROWS rows of them forward) of a warp's
    channels in a tile: csrc/depthwise_conv.cu's items."""
    return pl.images * pl.out_rows(backward) // \
        (1 if backward else dwc.FWD_ROWS) * pl.runs


def _slots(pl, backward):
    """A block's consumer warps, each on its own item."""
    return dwc.WARPS[pl.vec]["bwd" if backward else "fwd"]


def _walk(x, w, dy, pl):
    """csrc/depthwise_conv.cu's index arithmetic in numpy, float64: each
    block's tiles in order, the haloed and plain boxes the tensor maps give
    (zero outside, channels past C too), FWD_ROWS rows a thread forward, the
    weights turned 180° backward, the block's dw rows at b + chunk, and the
    finalize's sum over ``chunk_blocks``. Returns y (forward, dy None) or
    (dx, dw)."""
    n, c, h, wd = x.shape
    k, pad, cc, nb, th = pl.k, pl.k // 2, pl.chunk, pl.images, pl.rows
    wp, kk, bwd = pl.runs * dwc.RUN, pl.k ** 2, dy is not None
    rows = 1 if bwd else dwc.FWD_ROWS
    groups = pl.out_rows(bwd) // rows
    per, hts = pl.tiles // pl.chunks, -(-h // th)
    pad_c = pl.chunks * cc - c  # channels of the last chunk past C
    xl = np.pad(x.permute(0, 2, 3, 1).numpy(), [(0, 0)] * 3 + [(0, pad_c)])
    src = np.pad(dy.permute(0, 2, 3, 1).numpy(),
                 [(0, 0)] * 3 + [(0, pad_c)]) if bwd else xl
    wf = np.pad(w.reshape(c, kk).numpy(), [(0, pad_c), (0, 0)])
    out = np.zeros(xl.shape)
    scratch = np.full((pl.blocks + pl.chunks - 1, cc, kk), np.nan)

    def box(t, q, n0, w0, h0, bw, bh):
        """A tensor map's box at (q·cc, w0, h0, n0): zeros outside."""
        b = np.zeros((nb, bh, bw, cc))
        for i in range(nb):
            for r in range(bh):
                for col in range(bw):
                    nn, hh, ww = n0 + i, h0 + r, w0 + col
                    if nn < n and 0 <= hh < h and 0 <= ww < wd:
                        b[i, r, col] = t[nn, hh, ww, q * cc:(q + 1) * cc]
        return b

    for blk in range(pl.blocks):
        cur, dwacc = -1, None
        for u in dwc.block_tiles(pl, blk):
            q, rem = divmod(u, per)
            n0, h0 = rem // hts * nb, rem % hts * th
            if q != cur:
                if bwd and cur >= 0:
                    scratch[blk + cur] = dwacc[::-1].T
                wt = wf[q * cc:(q + 1) * cc].T  # (kk, cc)
                wt = wt[::-1] if bwd else wt
                dwacc, cur = np.zeros((kk, cc)), q
            halo = box(src, q, n0, -pad, h0 - pad, wp + k - 1,
                       groups * rows + k - 1)
            plain = box(xl, q, n0, 0, h0, wp, th) if bwd else None
            for it in range(_items(pl, bwd)):
                img, rem2 = divmod(it, groups * pl.runs)
                r0, w0 = rem2 // pl.runs * rows, rem2 % pl.runs * dwc.RUN
                acc = np.zeros((rows, dwc.RUN, cc))
                xc = plain[img, r0, w0:w0 + dwc.RUN] if bwd else None
                for kr in range(k + rows - 1):
                    for rr in range(rows):
                        ki = kr - rr
                        if not 0 <= ki < k:
                            continue
                        for kj in range(k):
                            v = halo[img, r0 + kr, w0 + kj:w0 + kj + dwc.RUN]
                            acc[rr] += v * wt[ki * k + kj]
                            if bwd:
                                dwacc[ki * k + kj] += (xc * v).sum(0)
                nn = n0 + img
                for rr in range(rows):
                    hh = h0 + r0 + rr
                    if nn >= n or r0 + rr >= th or hh >= h:
                        continue
                    for o in range(dwc.RUN):
                        if w0 + o < wd:
                            out[nn, hh, w0 + o, q * cc:(q + 1) * cc] = \
                                acc[rr, o]
        if bwd and cur >= 0:
            scratch[blk + cur] = dwacc[::-1].T
    res = torch.from_numpy(out[..., :c]).permute(0, 3, 1, 2)
    if not bwd:
        return res
    dw = np.zeros((c, kk))
    for ch in range(c):
        q, cl = divmod(ch, cc)
        for b in dwc.chunk_blocks(pl, q):
            dw[ch] += scratch[b + q, cl]
    return res, torch.from_numpy(dw).view(w.shape)


@pytest.mark.parametrize("shape,k,dtype,sms", [
    ((3, 144, 7, 9), 5, torch.bfloat16, 5),  # 3 chunks, the last part C
    ((3, 48, 7, 9), 3, torch.float32, 4),    # odd rows, row pairs
    ((5, 64, 8, 8), 5, torch.bfloat16, 3),   # images stacked, 5 of them
    ((2, 16, 34, 20), 5, torch.bfloat16, 7),  # rows cut, ragged runs
])
def test_the_kernels_walk_computes_the_convolution(shape, k, dtype, sms):
    x, w, dy = _tensors(shape, k, 5)
    pl = dwc.plan(shape[0], shape[2], shape[3], shape[1], dtype, sms, k)
    y_ref, dx_ref, dw_ref = _want(x, w, dy)
    torch.testing.assert_close(_walk(x, w, None, pl), y_ref)
    dx, dw = _walk(x, w, dy, pl)
    torch.testing.assert_close(dx, dx_ref)
    torch.testing.assert_close(dw, dw_ref)


# ----------------------------------------------------------- the plan ----

@pytest.mark.parametrize("c,h,w,calls", NVAE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_nvae_shapes(c, h, w, calls, dtype):
    n, sms = NVAE_BATCH, 132
    pl = dwc.plan(n, h, w, c, dtype, sms, 5)
    assert pl.chunk * pl.elem == 128 and c % pl.chunk == 0
    # the tiles cover the tensor once: whole images of rows, columns, chunks
    per = -(-n // pl.images) * -(-h // pl.rows)
    assert pl.tiles == per * pl.chunks == per * c // pl.chunk
    assert h % pl.rows == 0 and n % pl.images == 0
    assert pl.runs * dwc.RUN == w
    # ... and the blocks their range once, the grid on every SM
    assert pl.blocks == sms
    seen = [u for b in range(pl.blocks) for u in dwc.block_tiles(pl, b)]
    assert seen == list(range(pl.tiles))
    # every chunk's dw rows: the blocks whose range meets it, each once
    for q in range(pl.chunks):
        want = [b for b in range(pl.blocks)
                if any(u // per == q for u in dwc.block_tiles(pl, b))]
        assert list(dwc.chunk_blocks(pl, q)) == want
    # the ring: shared memory within the card's, stages in flight, and
    # every slot of every block busy but for one item at most
    for bwd in (False, True):
        assert pl.smem(bwd) <= dwc.SMEM_BYTES
        items = _items(pl, bwd) * -(-pl.tiles // pl.blocks)
        assert items >= 4 * _slots(pl, bwd)
    assert pl.stages_bwd >= 2
    assert pl.stages_fwd >= (3 if dtype == torch.bfloat16 else 2)
    assert 4 * pl.scratch_floats() <= SCRATCH_BYTES


def test_plan_refuses_what_no_tile_takes():
    with pytest.raises(ValueError, match="width"):
        dwc.plan(2, 8, 256, 64, torch.bfloat16, 132, 5)
    with pytest.raises(ValueError, match="16 bytes"):
        dwc.plan(2, 8, 8, 12, torch.bfloat16, 132, 5)
    with pytest.raises(ValueError, match="16 bytes"):
        dwc.plan(2, 8, 8, 6, torch.float32, 132, 5)
    with pytest.raises(ValueError, match="kernel size"):
        dwc.plan(2, 8, 8, 64, torch.bfloat16, 132, 7)
    with pytest.raises(TypeError):
        dwc.plan(2, 8, 8, 64, torch.float16, 132, 5)


# --------------------------------------------------- the dispatch rule ----

def _nvae_reference():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from reference import nvae as ref

    return ref, json.loads(NVAE_CONFIG.read_text())


def test_nvae_depthwise_convs_take_the_kernels_and_no_other():
    """The port's NVAE at its published widths: exactly the reference
    table's 72 depthwise entries take the kernels, by name."""
    from disentangle_mlp_tpu_torch.config import Config
    from disentangle_mlp_tpu_torch.models import nvae

    ref, c = _nvae_reference()
    cfg = Config(**{k: v for k, v in c.items()
                    if k in Config.__dataclass_fields__})
    model = nvae.NVAE(nvae.Arch.from_config(cfg), torch.bfloat16,
                      torch.Generator().manual_seed(0))
    convs = model.convs()
    taken = sorted(f"nvae.{name}" for name, m in convs if m.depthwise)
    want = sorted(l["name"] for l in ref.layers(c)
                  if l["kind"] == "conv" and l["groups"] > 1)
    assert len(want) == sum(n for *_, n in NVAE_SHAPES) == 72
    assert taken == want
    assert all(m.groups == 1 for _, m in convs if not m.depthwise)
    assert len(convs) - len(taken) == 448


def test_no_convolution_of_the_other_models_takes_the_kernels():
    """The β-VAE-GAN's and the VAE's encoder and decoder, the DCGAN's
    discriminator, the birds and MNIST families: every convolution has
    groups = 1 and stays on F.conv2d."""
    from disentangle_mlp_tpu_torch.models import (birds, gan, layers, mnist,
                                                  vae)

    g = torch.Generator().manual_seed(0)
    models = [vae.VAE(n_hidden=8, n_z=(16, 4, 4), representation_size=4,
                      head_width=32, decoder_channels=(8, 8, 8),
                      img_size=32, generator=g),
              gan.DiscriminatorCeleba(generator=g),
              birds.BirdsEncoder(n_z=8, generator=g),
              birds.BirdsGenerator(n_z=8, generator=g),
              birds.BirdsDiscriminator(generator=g),
              mnist.MnistEncoder(generator=g),
              mnist.MnistGenerator(generator=g),
              mnist.MnistDiscriminator(generator=g)]
    convs = [m for model in models for m in model.modules()
             if isinstance(m, layers.Conv)]
    assert len(convs) > 20
    assert all(m.groups == 1 and not m.depthwise for m in convs)


@pytest.mark.parametrize("kw,taken", [
    (dict(in_ch=8, features=8, kernel_size=5, padding=2, groups=8), True),
    (dict(in_ch=8, features=8, kernel_size=3, padding=1, groups=8), True),
    (dict(in_ch=8, features=8, kernel_size=5, padding=2, groups=1), False),
    (dict(in_ch=8, features=16, kernel_size=5, padding=2, groups=8), False),
    (dict(in_ch=8, features=8, kernel_size=5, padding=2, groups=8,
          stride=2), False),
    (dict(in_ch=8, features=8, kernel_size=5, padding=1, groups=8), False),
    (dict(in_ch=8, features=8, kernel_size=7, padding=3, groups=8), False),
    (dict(in_ch=8, features=8, kernel_size=1, padding=0, groups=8), False),
])
def test_the_rule_a_conv_takes_the_kernels_by(kw, taken):
    from disentangle_mlp_tpu_torch.models.layers import Conv

    m = Conv(**kw, generator=torch.Generator().manual_seed(1),
             bias="none", kernel_init="uniform")
    assert m.depthwise is taken
    x = torch.randn(2, 8, 9, 7, generator=torch.Generator().manual_seed(2))
    want = F.conv2d(x, m.weight, None, m.stride, m.padding, 1, m.groups)
    torch.testing.assert_close(m(x), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ counts, refusals --

class _Stream:
    cuda_stream = 4321


def test_a_capture_records_and_each_replay_adds_its_launches():
    before, paths = dwc.launches, collections.Counter(dwc.path_launches)
    counts = collections.Counter()
    with dwc.capture_scope(_Stream(), counts):
        dwc._count("fwd", _Stream.cuda_stream)
        dwc._count("bwd", _Stream.cuda_stream)
        dwc._count("fwd", 999)  # another stream counts at once
    assert counts == {"fwd": 1, "bwd": 1}
    assert dwc.launches == before + 1
    dwc.replayed(counts)
    dwc.replayed(counts)
    assert dwc.launches == before + 5
    assert dwc.path_launches - paths == {"fwd": 3, "bwd": 2}
    assert _Stream.cuda_stream not in dwc._recording


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("x,w,error,match", [
    (_cl(torch.zeros(2, 16, 4, 4, dtype=torch.float16)),
     torch.zeros(16, 1, 5, 5, dtype=torch.float16), TypeError, "float16"),
    (_cl(torch.zeros(2, 16, 4, 4, dtype=torch.float64)),
     torch.zeros(16, 1, 5, 5, dtype=torch.float64), TypeError, "float64"),
    (torch.zeros(16, 4, 4), torch.zeros(16, 1, 5, 5), ValueError, "N, C"),
    (_cl(torch.zeros(2, 16, 4, 4)), torch.zeros(16, 2, 5, 5), ValueError,
     "16, 1, k, k"),
    (_cl(torch.zeros(2, 16, 4, 4)), torch.zeros(16, 1, 7, 7), ValueError,
     "16, 1, k, k"),
    (_cl(torch.zeros(2, 16, 4, 4)), torch.zeros(16, 1, 4, 4), ValueError,
     "16, 1, k, k"),
    (_cl(torch.zeros(2, 16, 4, 4)),
     torch.zeros(16, 1, 5, 5, dtype=torch.bfloat16), ValueError, "dtype"),
    (_cl(torch.zeros(2, 16, 4, 4)), torch.zeros(16, 1, 5, 5).transpose(2, 3),
     ValueError, "contiguous"),
    (torch.zeros(2, 16, 4, 4), torch.zeros(16, 1, 5, 5), ValueError,
     "channels-last"),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(x, w, error,
                                                         match):
    with pytest.raises(error, match=match):
        dwc.check(x, w)


def test_a_channels_last_call_passes_the_check():
    dwc.check(_cl(torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16)),
              torch.zeros(16, 1, 5, 5, dtype=torch.bfloat16))


def test_x_and_w_on_two_devices_raise():
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        dwc.depthwise_conv(torch.zeros(1, 8, 4, 4, device="meta"),
                           torch.zeros(8, 1, 5, 5))


# ------------------------------------------------------------- the card --

def _compare(got, want, dtype):
    """Each output's error over its tolerance (module docstring)."""
    out = {}
    for key in ("y", "dx", "dw"):
        g, r = got[key].double(), want[key].double()
        scale = float(r.abs().max()) or 1.0
        bound = TOL[dtype][key] * scale
        if dtype == torch.bfloat16:
            bound = bound + BF16_STEP * r.abs()
        out[key] = float(((g - r).abs() / bound).max())
    return out


def _run(fn, x, w, dy):
    xg, wg = x.detach().clone().requires_grad_(), \
        w.detach().clone().requires_grad_()
    y = fn(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    return {"y": y.detach(), "dx": dx, "dw": dw}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((4, 64, 8, 8), 5), ((3, 48, 7, 9), 3),
                                     ((2, 16, 34, 20), 5),
                                     ((3, 144, 7, 9), 5),
                                     ((8, 768, 32, 32), 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernels_match_the_plain_version_on_the_card(card, shape, k,
                                                        dtype):
    x, w, dy = (t.to("cuda") for t in _tensors(shape, k, 9, dtype))
    x, dy = _cl(x), _cl(dy)
    got = _run(dwc.depthwise_conv, x, w, dy)
    again = _run(dwc.depthwise_conv, x, w, dy)
    want = _run(dwc.depthwise_conv_plain, x, w, dy)
    torch.cuda.synchronize()
    assert got["y"].is_contiguous(memory_format=torch.channels_last)
    assert got["dx"].is_contiguous(memory_format=torch.channels_last)
    assert all(torch.equal(got[key], again[key]) for key in got)
    err = _compare(got, want, dtype)
    assert max(err.values()) <= 1, err
    assert not math.isnan(sum(err.values()))
