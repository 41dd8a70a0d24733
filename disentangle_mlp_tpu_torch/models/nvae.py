"""NVAE, "A Deep Hierarchical Variational Autoencoder" (Vahdat & Kautz,
NeurIPS 2020, arXiv:2007.03898; github.com/NVlabs/NVAE), as its code builds
it for ``--arch_instance res_mbconv`` with ``--use_se --res_dist``, written
for this port's layers: bf16 compute, float32 parameters and statistics,
NCHW logical shapes over channels-last memory (the BatchNorm kernels read
channels contiguous).

- **Stem and preprocess.** ``Conv2D(3 → C_enc, 3×3)`` on the images in
  [-1, 1] (NVAE's ``2x − 1``), then ``PRE_BLOCKS`` blocks of
  ``PRE_CELLS`` cells, the last of each a down cell (×2 channels, /2
  pixels).
- **Encoder tower.** For each latent scale from the highest resolution, its
  groups (:func:`groups_per_scale`), each ``CELLS_ENC`` normal cells
  followed by a combiner slot (every group but the last of the last
  scale); a down cell between scales.
- **Decoder tower.** From the lowest resolution: for each group a
  combiner, preceded by ``CELLS_DEC`` normal cells except in the first
  group; an up cell between scales. It starts from ``prior_ftr0``, a
  learned (1, C, h, w) map.
- **Latent groups.** Group 0 (the top): ``enc0`` (ELU, 1×1 conv, ELU) of
  the encoder's last features, then ``enc_sampler[0]`` (3×3 conv to 2L
  channels) gives q; its prior is N(0, σ = exp(0) + 0.01). Group i > 0:
  ``dec_sampler[i-1]`` (ELU, 1×1 conv) of the decoder's state gives the
  prior's (μp, log σp); ``enc_comb[i-1]`` (x_enc + 1×1 conv of the
  decoder's state) then ``enc_sampler[i]`` give (μq, log σq); with
  ``res_dist`` q = N(μp + μq, log σp + log σq). μ and log σ pass
  5·tanh(·/5) and σ = exp(log σ) + 0.01 (ops/losses.py :func:`normal`).
  z = μ + σ·ε, then ``dec_comb[i]`` (1×1 conv of [state, z]).
- **Postprocess and image head.** ``POST_BLOCKS`` blocks of ``POST_CELLS``
  cells, the first an up cell; ELU and a 3×3 conv to 10·M channels, the
  logits of an M-component discretized logistic mixture.
- **Cells.** ``out = skip(x) + 0.1·SE(ops(x))``. SE: mean over the pixels,
  Linear(C → max(C/16, 4)), ReLU, Linear, sigmoid, a scale of x (both
  dense layers the port's bf16 :class:`Linear`, ``fused_linear``). Skip:
  the identity; :class:`FactorizedReduce` down; bilinear ×2
  (align_corners) and a 1×1 conv up. ``res_bnswish`` ops:
  [BN-Swish-Conv3×3(stride), BN-Swish-Conv3×3]; ``mconv_e{E}k5g0``:
  [nearest ×2 if up] BN, Conv1×1 → E·C, BN-Swish, depthwise Conv5×5,
  BN-Swish, Conv1×1 → C, BN.
- **Convolutions.** Weight-normalised with a bias (:class:`Conv`
  ``weight_norm``) everywhere but inside ``mconv`` cells, whose three
  convolutions have neither (NVAE's ``ConvBNSwish`` and the output
  projection). BatchNorm: eps 1e-5, NVAE's momentum 0.05 (this port's
  running-statistics decay 0.95), scale 1 and shift 0 at the start, each
  with its Swish fused into the kernels (ops/batchnorm.py).

The random draws of a step are one (B, E) float32 tensor ``eps``: every
group's ε, group 0 first, each (L, h, w) in NCHW order (:func:`latent_shapes`).

While the port's spans are on, every cell places the device marks
``dmt.nvae.<tower><k>#<call>.{fwd,bwd}.{begin,end}`` (tower ``pre``,
``enc``, ``dec`` or ``post``; k numbers its cells) around its forward and
its backward, as the BatchNorms do theirs.

Departures from NVAE's code: no normalizing flows (``num_nf 0``); no
data-dependent initialisation (NVAE's image head has none either, and the
configuration stands after its warm-up).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses
from ..utils import runtime
from .layers import BatchNorm, Conv, Linear, marked

CHANNEL_MULT = 2
# NVAE's sizes of its CelebA 64x64 command that no flag of the port sets:
# the preprocess and postprocess blocks and their cells, the cells of each
# group in either tower, the mixture's components
PRE_BLOCKS, PRE_CELLS = 1, 2
POST_BLOCKS, POST_CELLS = 1, 2
CELLS_ENC, CELLS_DEC = 2, 2
MIXTURE = 10
BN_EPS = 1e-5
BN_DECAY = 0.95          # NVAE's momentum 0.05
RESIDUAL_SCALE = 0.1
SE_MIN_HIDDEN = 4
CELL_OPS = {"normal_pre": "res_bnswish", "down_pre": "res_bnswish",
            "normal_enc": "res_bnswish", "down_enc": "res_bnswish",
            "normal_dec": "mconv_e6k5g0", "up_dec": "mconv_e6k5g0",
            "normal_post": "mconv_e3k5g0", "up_post": "mconv_e3k5g0"}


def groups_per_scale(num_scales: int, num_groups_per_scale: int,
                     ada_groups: bool, divider: int = 2,
                     minimum_groups: int = 1) -> List[int]:
    """NVAE's ``utils.groups_per_scale``: the groups of each scale from the
    highest resolution; with ``ada_groups`` each scale has half the groups
    of the one above (at least ``minimum_groups``)."""
    out, n = [], num_groups_per_scale
    for _ in range(num_scales):
        if n < 1:
            raise ValueError("a latent scale needs a group")
        out.append(n)
        if ada_groups:
            n = max(minimum_groups, n // divider)
    return out


@dataclasses.dataclass(frozen=True)
class Arch:
    """NVAE's sizes that its flags set here, under its flag names, and the
    image's; the rest are this module's constants."""
    num_channels_enc: int = 64
    num_channels_dec: int = 64
    num_latent_scales: int = 3
    num_groups_per_scale: int = 20
    ada_groups: bool = True
    num_latent_per_group: int = 20
    img_size: int = 64
    input_channels: int = 3

    @classmethod
    def from_config(cls, cfg) -> "Arch":
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})

    @property
    def groups(self) -> List[int]:
        return groups_per_scale(self.num_latent_scales,
                                self.num_groups_per_scale, self.ada_groups)

    @property
    def top_size(self) -> int:
        """Pixels on a side at the lowest latent scale."""
        return self.img_size // 2 ** (PRE_BLOCKS + self.num_latent_scales - 1)


# NVAE's flags (Config's NVAE fields): Arch's sizes but the image's
FLAGS = tuple(f.name for f in dataclasses.fields(Arch)
              if f.name not in ("img_size", "input_channels"))


def latent_shapes(arch: Arch) -> List[Tuple[int, int, int]]:
    """(L, h, w) of each latent group in the decoder's order: the lowest
    resolution's groups first."""
    out = []
    for s in range(arch.num_latent_scales):
        h = arch.top_size * 2 ** s
        out += [(arch.num_latent_per_group, h, h)] * \
            arch.groups[arch.num_latent_scales - s - 1]
    return out


def latent_width(arch: Arch) -> int:
    """E: the values of one image's draw, every group's ε."""
    return sum(c * h * w for c, h, w in latent_shapes(arch))


def split_eps(eps: torch.Tensor, arch: Arch) -> List[torch.Tensor]:
    """The (B, E) draw as each group's (B, L, h, w) ε, views."""
    out, at = [], 0
    for c, h, w in latent_shapes(arch):
        n = c * h * w
        out.append(eps[:, at:at + n].reshape(-1, c, h, w))
        at += n
    return out


class _Ctx:
    """What every layer of the model is built with."""

    def __init__(self, dtype: torch.dtype, generator):
        self.dtype, self.gen = dtype, generator

    def conv(self, cin, cout, k, stride=1, groups=1, wn=True, bias=True):
        return Conv(cin, cout, k, stride, (k - 1) // 2, self.dtype,
                    self.gen, bias="uniform" if bias else "none",
                    kernel_init="uniform", groups=groups, weight_norm=wn)

    def bn(self, c):
        m = BatchNorm(c, self.dtype, momentum=BN_DECAY, epsilon=BN_EPS,
                      generator=self.gen)
        with torch.no_grad():
            m.weight.fill_(1.0)
        return m

    def linear(self, fin, fout):
        return Linear(fin, fout, self.dtype, self.gen)


class BNSwishConv(nn.Module):
    """``res_bnswish``: BN-Swish, then a weight-normalised 3×3 conv."""

    def __init__(self, ctx: _Ctx, cin: int, cout: int, stride: int):
        super().__init__()
        self.bn = ctx.bn(cin)
        self.conv = ctx.conv(cin, cout, 3, stride)

    def forward(self, x):
        return self.conv(self.bn(x, activation="swish"))


class InvertedResidual(nn.Module):
    """``mconv_e{E}k5g0``: [nearest ×2] BN, 1×1 → E·C, BN-Swish, depthwise
    5×5, BN-Swish, 1×1 → C, BN; no weight norm, no bias."""

    def __init__(self, ctx: _Ctx, cin: int, cout: int, expand: int,
                 upsample: bool):
        super().__init__()
        hidden = cin * expand
        self.upsample = upsample
        self.bn0 = ctx.bn(cin)
        self.conv1 = ctx.conv(cin, hidden, 1, wn=False, bias=False)
        self.bn1 = ctx.bn(hidden)
        self.conv2 = ctx.conv(hidden, hidden, 5, groups=hidden, wn=False,
                              bias=False)
        self.bn2 = ctx.bn(hidden)
        self.conv3 = ctx.conv(hidden, cout, 1, wn=False, bias=False)
        self.bn3 = ctx.bn(cout)

    def forward(self, x):
        if self.upsample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = self.conv1(self.bn0(x))
        x = self.conv2(self.bn1(x, activation="swish"))
        x = self.conv3(self.bn2(x, activation="swish"))
        return self.bn3(x)


class SE(nn.Module):
    """Squeeze-excitation: x · sigmoid(W2 relu(W1 mean(x)))."""

    def __init__(self, ctx: _Ctx, c: int):
        super().__init__()
        hidden = max(c // 16, SE_MIN_HIDDEN)
        self.fc1 = ctx.linear(c, hidden)
        self.fc2 = ctx.linear(hidden, c)

    def forward(self, x):
        s = x.mean((2, 3))
        gate = torch.sigmoid(self.fc2(self.fc1(s, "relu")).float())
        return x * gate.to(x.dtype)[:, :, None, None]


class FactorizedReduce(nn.Module):
    """The down cells' skip: Swish, then four stride-2 1×1 convs of x
    shifted by (0, 0), (1, 1), (0, 1) and (1, 0), concatenated. A stride-2
    1×1 conv is a 1×1 conv of every other pixel, which is how it runs
    here: the same products and sums."""

    def __init__(self, ctx: _Ctx, cin: int, cout: int):
        super().__init__()
        q = cout // 4
        self.conv_1 = ctx.conv(cin, q, 1)
        self.conv_2 = ctx.conv(cin, q, 1)
        self.conv_3 = ctx.conv(cin, q, 1)
        self.conv_4 = ctx.conv(cin, cout - 3 * q, 1)

    def forward(self, x):
        a = F.silu(x)
        return torch.cat([self.conv_1(a[:, :, 0::2, 0::2]),
                          self.conv_2(a[:, :, 1::2, 1::2]),
                          self.conv_3(a[:, :, 0::2, 1::2]),
                          self.conv_4(a[:, :, 1::2, 0::2])], dim=1)


class UpSkip(nn.Module):
    """The up cells' skip: bilinear ×2 (align_corners), a 1×1 conv."""

    def __init__(self, ctx: _Ctx, cin: int, cout: int):
        super().__init__()
        self.conv = ctx.conv(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear",
                                       align_corners=True))


class Cell(nn.Module):
    """skip(x) + 0.1·SE(ops(x)); ``kind`` one of :data:`CELL_OPS`."""

    def __init__(self, ctx: _Ctx, kind: str, cin: int, cout: int,
                 trace_name: str):
        super().__init__()
        op = CELL_OPS[kind]
        down, up = kind.startswith("down"), kind.startswith("up")
        self.skip = (FactorizedReduce(ctx, cin, cout) if down else
                     UpSkip(ctx, cin, cout) if up else None)
        if op == "res_bnswish":
            if up:
                raise ValueError("res_bnswish up cells are not built here")
            ops = [BNSwishConv(ctx, cin, cout, 2 if down else 1),
                   BNSwishConv(ctx, cout, cout, 1)]
        else:
            if down:
                raise ValueError("mconv down cells are not built here")
            ops = [InvertedResidual(ctx, cin, cout, int(op[7]), up)]
        self.ops = nn.ModuleList(ops)
        self.se = SE(ctx, cout)
        self._trace_name, self._trace_calls = trace_name, 0

    def _cell(self, x):
        skip = x if self.skip is None else self.skip(x)
        s = x
        for op in self.ops:
            s = op(s)
        return skip + RESIDUAL_SCALE * self.se(s)

    def forward(self, x):
        if not runtime.spans_on():
            return self._cell(x)
        self._trace_calls += 1
        return marked(f"{self._trace_name}#{self._trace_calls}", self._cell,
                      x)


class NVAE(nn.Module):
    """The model; :meth:`forward` is the training pass, :meth:`sample` the
    generator. Module order follows NVAE's ``AutoEncoder.__init__``."""

    def __init__(self, arch: Arch, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        ctx = _Ctx(dtype, generator)
        a, L = arch, arch.num_latent_per_group
        scales, groups = a.num_latent_scales, a.groups
        top = a.top_size
        c_top = int(CHANNEL_MULT ** (PRE_BLOCKS + scales - 1)
                    * a.num_channels_dec)
        self.prior_ftr0 = nn.Parameter(
            torch.rand((1, c_top, top, top), generator=generator))
        self.stem = ctx.conv(a.input_channels, a.num_channels_enc, 3)

        mult, tags = 1, {"pre": 0, "enc": 0, "dec": 0, "post": 0}

        def cell(tower, kind, cin, cout):
            name = f"dmt.nvae.{tower}{tags[tower]}"
            tags[tower] += 1
            return Cell(ctx, kind, int(cin), int(cout), name)

        self.pre = nn.ModuleList()
        for _ in range(PRE_BLOCKS):
            for c in range(PRE_CELLS):
                ch = a.num_channels_enc * mult
                if c == PRE_CELLS - 1:
                    self.pre.append(cell("pre", "down_pre", ch,
                                         CHANNEL_MULT * ch))
                    mult *= CHANNEL_MULT
                else:
                    self.pre.append(cell("pre", "normal_pre", ch, ch))

        # the encoder tower: ("cell", i) and ("comb", i) in NVAE's order
        self.enc, self.enc_comb = nn.ModuleList(), nn.ModuleList()
        self.enc_plan: List[Tuple[str, int]] = []
        for s in range(scales):
            ch = int(a.num_channels_enc * mult)
            for g in range(groups[s]):
                for _ in range(CELLS_ENC):
                    self.enc_plan.append(("cell", len(self.enc)))
                    self.enc.append(cell("enc", "normal_enc", ch, ch))
                if not (s == scales - 1 and g == groups[s] - 1):
                    self.enc_plan.append(("comb", len(self.enc_comb)))
                    self.enc_comb.append(ctx.conv(
                        int(a.num_channels_dec * mult), ch, 1))
            if s < scales - 1:
                self.enc_plan.append(("cell", len(self.enc)))
                self.enc.append(cell("enc", "down_enc", ch,
                                     CHANNEL_MULT * ch))
                mult *= CHANNEL_MULT

        ch = int(a.num_channels_enc * mult)
        self.enc0 = ctx.conv(ch, ch, 1)
        self.enc_sampler, self.dec_sampler = nn.ModuleList(), nn.ModuleList()
        m = mult
        for s in range(scales):
            for g in range(groups[scales - s - 1]):
                self.enc_sampler.append(ctx.conv(
                    int(a.num_channels_enc * m), 2 * L, 3))
                if not (s == 0 and g == 0):
                    self.dec_sampler.append(ctx.conv(
                        int(a.num_channels_dec * m), 2 * L, 1))
            m /= CHANNEL_MULT

        self.dec, self.dec_comb = nn.ModuleList(), nn.ModuleList()
        self.dec_plan: List[Tuple[str, int]] = []
        for s in range(scales):
            ch = int(a.num_channels_dec * mult)
            for g in range(groups[scales - s - 1]):
                if not (s == 0 and g == 0):
                    for _ in range(CELLS_DEC):
                        self.dec_plan.append(("cell", len(self.dec)))
                        self.dec.append(cell("dec", "normal_dec", ch, ch))
                self.dec_plan.append(("comb", len(self.dec_comb)))
                self.dec_comb.append(ctx.conv(ch + L, ch, 1))
            if s < scales - 1:
                self.dec_plan.append(("cell", len(self.dec)))
                self.dec.append(cell("dec", "up_dec", ch,
                                     ch / CHANNEL_MULT))
                mult /= CHANNEL_MULT

        self.post = nn.ModuleList()
        for _ in range(POST_BLOCKS):
            for c in range(POST_CELLS):
                ch = a.num_channels_dec * mult
                if c == 0:
                    self.post.append(cell("post", "up_post", ch,
                                          ch / CHANNEL_MULT))
                    mult /= CHANNEL_MULT
                else:
                    self.post.append(cell("post", "normal_post", ch, ch))
        self.head = ctx.conv(int(a.num_channels_dec * mult),
                             10 * MIXTURE, 3)

    # -- the passes ---------------------------------------------------------

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def _decode(self, s: torch.Tensor, z0: torch.Tensor, next_z
                ) -> torch.Tensor:
        """The decoder tower from state ``s`` with the top group's ``z0``;
        ``next_z(i, s)`` gives group i's z from the decoder's state."""
        gi = 0
        for kind, i in self.dec_plan:
            if kind == "cell":
                s = self.dec[i](s)
                continue
            z = z0 if gi == 0 else next_z(gi, s)
            s = self.dec_comb[i](torch.cat([s, self._cast(z)], dim=1))
            gi += 1
        for c in self.post:
            s = c(s)
        logits = self.head(F.elu(s))
        return logits.permute(0, 2, 3, 1)

    def _start(self, batch: int) -> torch.Tensor:
        return self._cast(self.prior_ftr0).expand(batch, -1, -1, -1) \
            .contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, H, W, C) images in [-1, 1]; eps: the (B, E) draw. Returns
        the image head's logits (B, H, W, 10·M) and each group's KL summed
        over its latents, (B,) float32."""
        eps = split_eps(eps, self.arch)
        s = self.stem(self._cast(x).permute(0, 3, 1, 2))
        for c in self.pre:
            s = c(s)
        saved = []
        for kind, i in self.enc_plan:
            if kind == "cell":
                s = self.enc[i](s)
            else:
                saved.append((i, s))
        saved.reverse()
        ftr = F.elu(self.enc0(F.elu(s)))
        mu_q, ls_q = self.enc_sampler[0](ftr).float().chunk(2, dim=1)
        mq, sq = losses.normal(mu_q, ls_q)
        z0 = mq + sq * eps[0]
        zeros = torch.zeros_like(z0)
        kls = [losses.normal_kl(mq, sq, *losses.normal(zeros, zeros))]

        def next_z(gi, s):
            mu_p, ls_p = self.dec_sampler[gi - 1](F.elu(s)).float() \
                .chunk(2, dim=1)
            ci, enc_s = saved[gi - 1]
            ftr = enc_s + self.enc_comb[ci](s)
            mu_q, ls_q = self.enc_sampler[gi](ftr).float().chunk(2, dim=1)
            mq, sq = losses.normal(mu_p + mu_q, ls_p + ls_q)
            z = mq + sq * eps[gi]
            kls.append(losses.normal_kl(mq, sq, *losses.normal(mu_p, ls_p)))
            return z

        logits = self._decode(self._start(x.shape[0]), z0, next_z)
        with runtime.span("dmt.nvae.kl"):
            kl = [k.sum((1, 2, 3)) for k in kls]
        return logits, kl

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, C) in [-1, 1] from the prior, every group's ε
        given as :meth:`forward` takes them: each group's z = μp + σp·ε,
        group 0's from N(0, 1.01²); a pixel is the mixture's mean
        (ops/losses.py :func:`disc_mix_logistic_mean`)."""
        eps = split_eps(eps, self.arch)
        zeros = torch.zeros_like(eps[0])
        mp, sp = losses.normal(zeros, zeros)

        def next_z(gi, s):
            mu_p, ls_p = self.dec_sampler[gi - 1](F.elu(s)).float() \
                .chunk(2, dim=1)
            mp, sp = losses.normal(mu_p, ls_p)
            return mp + sp * eps[gi]

        logits = self._decode(self._start(eps[0].shape[0]),
                              mp + sp * eps[0], next_z)
        return losses.disc_mix_logistic_mean(logits.float(),
                                             MIXTURE)

    # -- the regularisers -----------------------------------------------------

    def convs(self) -> List[Tuple[str, Conv]]:
        return [(n, m) for n, m in self.named_modules()
                if isinstance(m, Conv)]

    def batchnorms(self) -> List[BatchNorm]:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]


def spectral_groups(convs: Sequence[Tuple[str, Conv]]
                    ) -> Dict[Tuple[int, int], List[str]]:
    """NVAE's batching of the spectral regularisation: the convolutions'
    (out, in·k·k) kernel matrices grouped by shape, each group's names
    sorted."""
    groups: Dict[Tuple[int, int], List[str]] = {}
    for name, m in convs:
        w = m.weight
        groups.setdefault((w.shape[0], w[0].numel()), []).append(name)
    return {k: sorted(v) for k, v in groups.items()}


def spectral_buffer_names(shape: Tuple[int, int]) -> Tuple[str, str]:
    return f"sr_u_{shape[0]}x{shape[1]}", f"sr_v_{shape[0]}x{shape[1]}"
