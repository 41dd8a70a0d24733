"""Plain float32 reference of one NVAE training step (Vahdat & Kautz,
"NVAE: A Deep Hierarchical Variational Autoencoder", NeurIPS 2020,
arXiv:2007.03898), written from NVAE's code (github.com/NVlabs/NVAE:
model.py ``AutoEncoder``, neural_operations.py, distributions.py,
thirdparty/adamax.py, train.py) for ``--arch_instance res_mbconv --use_se
--res_dist``, and not from the program under test, which this module never
imports. Weights are a dict of float32 tensors keyed ``nvae.<module
path>.<weight|bias|log_weight_norm|running_mean|running_var>``, torch
layouts.

One step, per batch x (B, H, W, 3) in [-1, 1] and every group's ε (B, E):

- stem 3×3 conv; preprocess cells; the encoder tower (per scale from 32×32
  at the published widths: groups of ``num_cell_per_cond_enc``
  ``res_bnswish`` cells, each group but the last one's features kept for a
  combiner; down cells between scales); ``enc0`` (ELU, 1×1, ELU) and
  ``enc_sampler.0`` give the top group's q, its prior N(0, exp(0) +
  0.01); the decoder tower from ``prior_ftr0`` (per scale from 8×8: each
  group's prior from ``dec_sampler`` (ELU, 1×1) of the state, q from
  ``enc_sampler`` of ``x_enc + enc_comb(state)`` as N(μp + μq, log σp +
  log σq), z = μq + σq·ε, the state ``dec_comb(cat(state, z))``, with
  ``num_cell_per_cond_dec`` ``mconv_e6k5g0`` cells before each group but
  the first; up cells between scales); postprocess cells; ELU and the 3×3
  image head;
- a cell is skip(x) + 0.1·SE(ops(x)); μ, log σ pass 5·tanh(·/5), σ =
  exp(log σ) + 0.01; the KL is analytic, summed per group;
- loss = mean_b(−log p(x_b) + Σ_g KL_g,b) + 0.1·(Σ σ_max + Σ_BN max|γ|):
  the 10-component discretized logistic mixture, σ_max from NVAE's batched
  power iteration over every convolution's kernel matrix (after weight
  normalisation; matrices batched by shape, each batch's convolutions
  taken in the order of their names; 40 iterations in the first step, 4
  after);
- one Adamax step (lr, eps 1e-3, L2 weight decay ``weight_decay``) on
  every parameter.

BatchNorm: train mode, eps 1e-5, momentum 0.05 (running statistics 0.95 of
their value plus 0.05 of the batch's mean and Bessel-corrected variance).

Tensors that ``celeba.init_weights``'s kinds (``conv``, ``conv_t``,
``linear``, ``bn``) do not make are derived from its draws by
:func:`derive`, which the program's side (``experiments/nvae.py``) calls
on the same draws: each weight-normalised convolution's ``log_weight_norm``
= log(‖v‖ + 0.01) (NVAE's own); ``prior_ftr0`` from the U(±1/8) draws of
the (512, 64) ``linear`` entry ``nvae.prior_ftr0_init`` as (u + 1)/2 in
[0, 1) (NVAE's ``torch.rand``); the power iteration's vectors
``nvae.sr_u_<rows>x<cols>`` / ``sr_v_...`` as the rows of the ``linear``
entries ``..._init``, normalised. Biases NVAE's convolutions lack are
deleted.

Departures from NVAE, and readings of it:

- no normalizing flows (``--num_nf 0``, the configuration's cut);
- the draws are the bench's (N(0, 0.02²) kernels, N(1, 0.02²) BatchNorm
  scales, PyTorch's uniform biases and dense layers), not NVAE's
  PyTorch-default init, and there is no data-dependent init (the
  configuration stands after NVAE's warm-ups);
- KL coefficient 1 and no KL balancing, lr held: NVAE's objective after
  its KL and lr warm-ups (the configuration's ``assumed``);
- the mixture's edge levels are x < −0.999 and x > 0.999 (PixelCNN++'s;
  NVAE's code has 0.99, which with 8-bit levels k/255 takes level 254 as
  an edge as well, and the probabilities over the 256 levels then sum to
  more than 1);
- float32 throughout (NVAE trained under fp16 autocast), TF32 off, and
  each cell recomputed in its backward (``torch.utils.checkpoint``), which
  changes no arithmetic; the running statistics move once.

``q`` (nets.Precision) rounds each convolution's and dense layer's
operands and outputs and each BatchNorm's output, as in nets.py.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import nets

METRICS = ("loss", "recon", "kl", "spectral", "bn")
P = "nvae"
CHANNEL_MULT = 2
BN_EPS, BN_KEEP = 1e-5, 0.95
CELL_OPS = {"normal_pre": "res_bnswish", "down_pre": "res_bnswish",
            "normal_enc": "res_bnswish", "down_enc": "res_bnswish",
            "normal_dec": "mconv_e6k5g0", "up_dec": "mconv_e6k5g0",
            "normal_post": "mconv_e3k5g0", "up_post": "mconv_e3k5g0"}
POWER_ITERATIONS = 4


def groups_per_scale(c: Dict) -> List[int]:
    """NVAE's ``groups_per_scale``: from the highest resolution, halved
    scale by scale with ``ada_groups`` (at least 1)."""
    out, n = [], c["num_groups_per_scale"]
    for _ in range(c["num_latent_scales"]):
        out.append(n)
        if c["ada_groups"]:
            n = max(1, n // 2)
    return out


def latent_shapes(c: Dict) -> List[Tuple[int, int, int]]:
    """(L, h, w) of each group in the decoder's order (8×8 first)."""
    top = c["img_size"] // 2 ** (c["num_preprocess_blocks"]
                                 + c["num_latent_scales"] - 1)
    g = groups_per_scale(c)
    s = c["num_latent_scales"]
    L = c["num_latent_per_group"]
    return [(L, top << i, top << i) for i in range(s)
            for _ in range(g[s - 1 - i])]


# -- the layer table ----------------------------------------------------------

def _conv(name, cin, cout, k, hw_in, stride=1, groups=1, wn=True,
          bias=True) -> Dict:
    return {"name": name, "kind": "conv", "cin": cin // groups,
            "cout": cout, "k": k, "stride": stride, "hw_in": hw_in,
            "groups": groups, "wn": wn, "bias": bias}


def _bn(name, features, hw, act) -> Dict:
    return {"name": name, "kind": "bn", "features": features, "hw": hw,
            "act": act}


def _linear(name, fin, fout, derived=None) -> Dict:
    out = {"name": name, "kind": "linear", "fin": fin, "fout": fout}
    if derived:
        out["derived"] = derived
    return out


def _cell(name: str, kind: str, cin: int, cout: int, hw: int):
    """(layers, description) of a cell whose input is hw×hw."""
    op = CELL_OPS[kind]
    down, up = kind.startswith("down"), kind.startswith("up")
    out: List[Dict] = []
    if down:
        q = cout // 4
        out += [_conv(f"{name}.skip.conv_{j}", cin,
                      q if j < 4 else cout - 3 * q, 1, hw, stride=2)
                for j in (1, 2, 3, 4)]
    if up:
        out.append(_conv(f"{name}.skip.conv", cin, cout, 1, 2 * hw,
                         bias=False))
    if op == "res_bnswish":
        hw2 = hw // 2 if down else hw
        out += [_bn(f"{name}.ops.0.bn", cin, hw, "swish"),
                _conv(f"{name}.ops.0.conv", cin, cout, 3, hw,
                      stride=2 if down else 1),
                _bn(f"{name}.ops.1.bn", cout, hw2, "swish"),
                _conv(f"{name}.ops.1.conv", cout, cout, 3, hw2)]
    else:
        e = int(op[7])
        h, hid = (2 * hw if up else hw), cin * e
        o = f"{name}.ops.0"
        out += [_bn(f"{o}.bn0", cin, h, "none"),
                _conv(f"{o}.conv1", cin, hid, 1, h, wn=False, bias=False),
                _bn(f"{o}.bn1", hid, h, "swish"),
                _conv(f"{o}.conv2", hid, hid, 5, h, groups=hid, wn=False,
                      bias=False),
                _bn(f"{o}.bn2", hid, h, "swish"),
                _conv(f"{o}.conv3", hid, cout, 1, h, wn=False, bias=False),
                _bn(f"{o}.bn3", cout, h, "none")]
    se = max(cout // 16, 4)
    out += [_linear(f"{name}.se.fc1", cout, se),
            _linear(f"{name}.se.fc2", se, cout)]
    return out, {"name": name, "op": op, "down": down, "up": up}


def _build(c: Dict):
    """(layers, net): the layer table in the program's module order and the
    structure the step walks."""
    g, scales = groups_per_scale(c), c["num_latent_scales"]
    L, img = c["num_latent_per_group"], c["img_size"]
    ce, cd = c["num_channels_enc"], c["num_channels_dec"]
    top = img // 2 ** (c["num_preprocess_blocks"] + scales - 1)
    c_top = int(CHANNEL_MULT ** (c["num_preprocess_blocks"] + scales - 1)
                * cd)
    layers = [_linear(f"{P}.prior_ftr0_init", top * top, c_top, "prior"),
              _conv(f"{P}.stem", c["input_channels"], ce, 3, img)]
    net: Dict = {"prior": (c_top, top), "pre": [], "enc": [], "dec": [],
                 "post": []}
    mult, hw = 1, img

    def cell(tower, kind, cin, cout):
        ls, d = _cell(f"{P}.{tower}.{cell.n[tower]}", kind, int(cin),
                      int(cout), hw)
        cell.n[tower] += 1
        layers.extend(ls)
        return d
    cell.n = {"pre": 0, "enc": 0, "dec": 0, "post": 0}

    for _ in range(c["num_preprocess_blocks"]):
        for i in range(c["num_preprocess_cells"]):
            ch = ce * mult
            if i == c["num_preprocess_cells"] - 1:
                net["pre"].append(cell("pre", "down_pre", ch,
                                       CHANNEL_MULT * ch))
                mult, hw = mult * CHANNEL_MULT, hw // 2
            else:
                net["pre"].append(cell("pre", "normal_pre", ch, ch))
    combs = []
    for s in range(scales):
        ch = int(ce * mult)
        for j in range(g[s]):
            for _ in range(c["num_cell_per_cond_enc"]):
                net["enc"].append(("cell",
                                   cell("enc", "normal_enc", ch, ch)))
            if not (s == scales - 1 and j == g[s] - 1):
                name = f"{P}.enc_comb.{len(combs)}"
                combs.append(_conv(name, int(cd * mult), ch, 1, hw))
                net["enc"].append(("comb", name))
        if s < scales - 1:
            net["enc"].append(("cell", cell("enc", "down_enc", ch,
                                            CHANNEL_MULT * ch)))
            mult, hw = mult * CHANNEL_MULT, hw // 2
    layers += combs
    ch = int(ce * mult)
    layers.append(_conv(f"{P}.enc0", ch, ch, 1, hw))
    enc_s, dec_s, m, h = [], [], mult, hw
    for s in range(scales):
        for j in range(g[scales - s - 1]):
            enc_s.append(_conv(f"{P}.enc_sampler.{len(enc_s)}",
                               int(ce * m), 2 * L, 3, h))
            if not (s == 0 and j == 0):
                dec_s.append(_conv(f"{P}.dec_sampler.{len(dec_s)}",
                                   int(cd * m), 2 * L, 1, h))
        m, h = m / CHANNEL_MULT, h * 2
    layers += enc_s + dec_s
    dcombs = []
    for s in range(scales):
        ch = int(cd * mult)
        for j in range(g[scales - s - 1]):
            if not (s == 0 and j == 0):
                for _ in range(c["num_cell_per_cond_dec"]):
                    net["dec"].append(("cell",
                                       cell("dec", "normal_dec", ch, ch)))
            name = f"{P}.dec_comb.{len(dcombs)}"
            dcombs.append(_conv(name, ch + L, ch, 1, hw))
            net["dec"].append(("comb", name))
        if s < scales - 1:
            net["dec"].append(("cell", cell("dec", "up_dec", ch,
                                            ch / CHANNEL_MULT)))
            mult, hw = mult / CHANNEL_MULT, hw * 2
    layers += dcombs
    for _ in range(c["num_postprocess_blocks"]):
        for i in range(c["num_postprocess_cells"]):
            ch = cd * mult
            if i == 0:
                net["post"].append(cell("post", "up_post", ch,
                                        ch / CHANNEL_MULT))
                mult, hw = mult / CHANNEL_MULT, hw * 2
            else:
                net["post"].append(cell("post", "normal_post", ch, ch))
    layers.append(_conv(f"{P}.head", int(cd * mult),
                        10 * c["num_mixture_dec"], 3, hw))
    for shape, names in spectral_groups(layers).items():
        r, k = shape
        layers += [_linear(f"{P}.sr_u_{r}x{k}_init", r, len(names), "u"),
                   _linear(f"{P}.sr_v_{r}x{k}_init", k, len(names), "v")]
    return layers, net


def spectral_groups(layers) -> Dict[Tuple[int, int], List[str]]:
    """The convolutions' names by (out, in/groups·k·k), each list sorted."""
    out: Dict[Tuple[int, int], List[str]] = {}
    for l in layers:
        if l["kind"] == "conv":
            out.setdefault((l["cout"], l["cin"] * l["k"] ** 2),
                           []).append(l["name"])
    return {k: sorted(v) for k, v in out.items()}


def layers(c: Dict) -> List[Dict]:
    return _build(c)[0]


def draw(gen: torch.Generator, c: Dict, batch: int, device) -> Dict:
    """Every group's ε, one (B, E) tensor, groups in the decoder's order,
    each (L, h, w) in NCHW order."""
    e = sum(a * b * d for a, b, d in latent_shapes(c))
    return {"eps": torch.randn((batch, e), generator=gen, device=device)}


def derive(w: nets.Weights, c: Dict) -> None:
    """The tensors no draw kind makes, from the draws, in place (see the
    module docstring): ``log_weight_norm``, ``prior_ftr0``, the power
    iteration's vectors; the biases NVAE lacks deleted."""
    table = layers(c)
    with torch.no_grad():
        for l in table:
            name = l["name"]
            if l["kind"] == "conv":
                if not l["bias"]:
                    del w[name + ".bias"]
                if l["wn"]:
                    v = w[name + ".weight"]
                    w[name + ".log_weight_norm"] = torch.log(
                        v.flatten(1).norm(dim=1) + 1e-2).view(-1, 1, 1, 1) \
                        .clone().requires_grad_()
            elif l.get("derived"):
                t = w.pop(name + ".weight").detach()
                del w[name + ".bias"]
                if l["derived"] == "prior":
                    ch, top = _build(c)[1]["prior"]
                    u = (t * math.sqrt(l["fin"]) + 1.0) / 2.0
                    w[f"{P}.prior_ftr0"] = u.reshape(1, ch, top, top) \
                        .clone().requires_grad_()
                else:
                    w[name[:-len("_init")]] = F.normalize(t, dim=1,
                                                          eps=1e-3).clone()


# -- the step ---------------------------------------------------------------------

class _Stats:
    """Whether a BatchNorm moves its running statistics: not while a
    checkpointed cell is recomputed."""
    moving = True


def batch_norm(w, name, x, q, act):
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    n = x.numel() // x.shape[1]
    if _Stats.moving:
        with torch.no_grad():
            rm, rv = w[name + ".running_mean"], w[name + ".running_var"]
            rm.mul_(BN_KEEP).add_((1 - BN_KEEP) * mean)
            rv.mul_(BN_KEEP).add_((1 - BN_KEEP) * var * (n / (n - 1)))
    y = (x - mean[:, None, None]) * (torch.rsqrt(var + BN_EPS)
                                     * w[name + ".weight"])[:, None, None] \
        + w[name + ".bias"][:, None, None]
    if act == "swish":
        y = y * torch.sigmoid(y)
    return q.out(y)


def kernel(w, name) -> torch.Tensor:
    """A convolution's kernel as NVAE's ``Conv2D`` uses it:
    exp(log_g)·v/(‖v‖ + 1e-5) where it is weight-normalised."""
    v = w[name + ".weight"]
    g = w.get(name + ".log_weight_norm")
    if g is None:
        return v
    norm = torch.sqrt(torch.sum(v * v, dim=[1, 2, 3]))
    return torch.exp(g) * v / (norm.view(-1, 1, 1, 1) + 1e-5)


def conv(w, name, x, q, stride=1, groups=1):
    k = w[name + ".weight"].shape[-1]
    return q.out(F.conv2d(q(x), q(kernel(w, name)), w.get(name + ".bias"),
                          stride, (k - 1) // 2, 1, groups))


def linear(w, name, x, q):
    return q.out(F.linear(q(x), q(w[name + ".weight"]), w[name + ".bias"]))


def cell(w, d, x, q):
    name = d["name"]
    if d["down"]:
        a = F.silu(x)
        skip = torch.cat([conv(w, f"{name}.skip.conv_1", a, q, 2),
                          conv(w, f"{name}.skip.conv_2", a[:, :, 1:, 1:], q,
                               2),
                          conv(w, f"{name}.skip.conv_3", a[:, :, :, 1:], q,
                               2),
                          conv(w, f"{name}.skip.conv_4", a[:, :, 1:, :], q,
                               2)], dim=1)
    elif d["up"]:
        skip = conv(w, f"{name}.skip.conv", F.interpolate(
            x, scale_factor=2, mode="bilinear", align_corners=True), q)
    else:
        skip = x
    s = x
    if d["op"] == "res_bnswish":
        for i, stride in ((0, 2 if d["down"] else 1), (1, 1)):
            s = conv(w, f"{name}.ops.{i}.conv",
                     batch_norm(w, f"{name}.ops.{i}.bn", s, q, "swish"), q,
                     stride)
    else:
        o = f"{name}.ops.0"
        if d["up"]:
            s = F.interpolate(s, scale_factor=2, mode="nearest")
        s = conv(w, f"{o}.conv1", batch_norm(w, f"{o}.bn0", s, q, "none"), q)
        s = batch_norm(w, f"{o}.bn1", s, q, "swish")
        s = conv(w, f"{o}.conv2", s, q, groups=s.shape[1])
        s = batch_norm(w, f"{o}.bn2", s, q, "swish")
        s = batch_norm(w, f"{o}.bn3", conv(w, f"{o}.conv3", s, q), q,
                       "none")
    h = F.relu(linear(w, f"{name}.se.fc1", s.mean((2, 3)), q))
    gate = torch.sigmoid(linear(w, f"{name}.se.fc2", h, q))
    return skip + 0.1 * (s * gate[:, :, None, None])


def run_cell(w, d, x, q):
    """:func:`cell`, recomputed in the backward; the running statistics
    move in the first pass alone."""
    passes = [0]

    def body(t):
        passes[0] += 1
        _Stats.moving = passes[0] == 1
        try:
            return cell(w, d, t, q)
        finally:
            _Stats.moving = True

    return checkpoint(body, x, use_reentrant=False)


def normal(mu, log_sigma):
    mu = 5.0 * torch.tanh(mu / 5.0)
    return mu, torch.exp(5.0 * torch.tanh(log_sigma / 5.0)) + 1e-2


def kl_normal(mq, sq, mp, sp):
    t1 = (mq - mp) / sp
    t2 = sq / sp
    return 0.5 * (t1 * t1 + t2 * t2) - 0.5 - torch.log(t2)


def mixture_nll(logits, x, num_mix: int):
    """NVAE's ``DiscMixLogistic.log_prob`` (NCHW), negated and summed over
    the pixels, with PixelCNN++'s edges; x (B, 3, H, W) in [-1, 1]."""
    b, _, h, wd = logits.shape
    m = num_mix
    logit_probs = logits[:, :m]
    l = logits[:, m:].reshape(b, 3, 3 * m, h, wd)
    means = l[:, :, :m]
    log_scales = torch.clamp(l[:, :, m:2 * m], min=-7.0)
    coeffs = torch.tanh(l[:, :, 2 * m:3 * m])
    xs = x.unsqueeze(4).expand(-1, -1, -1, -1, m).permute(0, 1, 4, 2, 3)
    mean1 = means[:, 0]
    mean2 = means[:, 1] + coeffs[:, 0] * xs[:, 0]
    mean3 = means[:, 2] + coeffs[:, 1] * xs[:, 0] + coeffs[:, 2] * xs[:, 1]
    centered = xs - torch.stack([mean1, mean2, mean3], dim=1)
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / 255.0)
    min_in = inv_stdv * (centered - 1.0 / 255.0)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    mid = torch.where(cdf_delta > 1e-5,
                      torch.log(torch.clamp(cdf_delta, min=1e-10)),
                      log_pdf_mid - math.log(127.5))
    lp = torch.where(xs < -0.999, log_cdf_plus,
                     torch.where(xs > 0.999, log_one_minus_cdf_min, mid))
    lp = lp.sum(1) + F.log_softmax(logit_probs, dim=1)
    return -torch.logsumexp(lp, dim=1).sum((1, 2))


class Adamax:
    """NVAE's Adamax: g + wd·p; m ← 0.9m + 0.1g; u ← max(0.999u, |g| +
    eps); p ← p − lr/(1 − 0.9^t)·m/u."""

    def __init__(self, params, lr, weight_decay, b1=0.9, b2=0.999,
                 eps=1e-3):
        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        b1, b2, eps)
        self.t = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        clr = self.lr / (1 - self.b1 ** self.t)
        for p, g, m, u in zip(self.params, grads, self.mu, self.nu):
            g = (torch.zeros_like(p) if g is None else g) + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            u.copy_(torch.maximum(u * self.b2, g.abs() + self.eps))
            p.sub_(clr * (m / u))


class Model:
    def __init__(self, c: Dict, w: nets.Weights):
        derive(w, c)
        self.c, self.w = c, w
        self.table, self.net = _build(c)
        self.keys = [k for k, t in w.items() if t.requires_grad]
        self.opt = Adamax([w[k] for k in self.keys], c["lr"],
                          c["weight_decay"])
        self.groups = {"nvae": self.keys}
        self.spectral = spectral_groups(self.table)
        self.bns = [l["name"] for l in self.table if l["kind"] == "bn"]
        self.iterations = 10 * POWER_ITERATIONS
        self.kl_groups = None

    def moments(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.keys, self.opt.mu))

    def forward(self, x, eps, q):
        """(logits NCHW, [KL of each group (B,)])."""
        w, c, net = self.w, self.c, self.net
        shapes = latent_shapes(c)
        at, parts = 0, []
        for sh in shapes:
            n = sh[0] * sh[1] * sh[2]
            parts.append(eps[:, at:at + n].reshape(-1, *sh))
            at += n
        s = conv(w, f"{P}.stem", x.permute(0, 3, 1, 2).contiguous(), q)
        for d in net["pre"]:
            s = run_cell(w, d, s, q)
        saved = []
        for kind, d in net["enc"]:
            if kind == "cell":
                s = run_cell(w, d, s, q)
            else:
                saved.append((d, s))
        saved.reverse()
        ftr = F.elu(conv(w, f"{P}.enc0", F.elu(s), q))
        mu_q, ls_q = conv(w, f"{P}.enc_sampler.0", ftr, q).chunk(2, dim=1)
        mq, sq = normal(mu_q, ls_q)
        z = mq + sq * parts[0]
        zero = torch.zeros_like(z)
        kls = [kl_normal(mq, sq, *normal(zero, zero))]
        ch, top = net["prior"]
        s = w[f"{P}.prior_ftr0"].expand(x.shape[0], ch, top, top)
        gi = 0
        for kind, d in net["dec"]:
            if kind == "cell":
                s = run_cell(w, d, s, q)
                continue
            if gi > 0:
                mu_p, ls_p = conv(w, f"{P}.dec_sampler.{gi - 1}", F.elu(s),
                                  q).chunk(2, dim=1)
                name, enc = saved[gi - 1]
                ftr = enc + conv(w, name, s, q)
                mu_q, ls_q = conv(w, f"{P}.enc_sampler.{gi}", ftr,
                                  q).chunk(2, dim=1)
                mq, sq = normal(mu_p + mu_q, ls_p + ls_q)
                z = mq + sq * parts[gi]
                kls.append(kl_normal(mq, sq, *normal(mu_p, ls_p)))
            s = conv(w, d, torch.cat([s, z], dim=1), q)
            gi += 1
        for d in net["post"]:
            s = run_cell(w, d, s, q)
        logits = conv(w, f"{P}.head", F.elu(s), q)
        return logits, [k.sum((1, 2, 3)) for k in kls]

    def spectral_loss(self) -> torch.Tensor:
        steps, self.iterations = self.iterations, POWER_ITERATIONS
        total = 0.0
        for (r, k), names in self.spectral.items():
            u = self.w[f"{P}.sr_u_{r}x{k}"]
            v = self.w[f"{P}.sr_v_{r}x{k}"]
            mats = torch.stack([kernel(self.w, n).reshape(r, k)
                                for n in names])
            with torch.no_grad():
                for _ in range(steps):
                    v.copy_(F.normalize(torch.matmul(u.unsqueeze(1), mats)
                                        .squeeze(1), dim=1, eps=1e-3))
                    u.copy_(F.normalize(torch.matmul(mats, v.unsqueeze(2))
                                        .squeeze(2), dim=1, eps=1e-3))
            total = total + torch.matmul(
                u.unsqueeze(1), torch.matmul(mats, v.unsqueeze(2))).sum()
        return total

    def step(self, x: torch.Tensor, d: Dict, q: nets.Precision = nets.EXACT
             ) -> Dict[str, torch.Tensor]:
        c = self.c
        logits, kls = self.forward(x, d["eps"], q)
        recon = mixture_nll(logits, x.permute(0, 3, 1, 2),
                            c["num_mixture_dec"])
        kl = torch.stack(kls, dim=1)
        self.kl_groups = kl.detach().mean(0)
        spectral = self.spectral_loss()
        bn = sum(self.w[n + ".weight"].abs().max() for n in self.bns)
        loss = (recon + kl.sum(1)).mean() \
            + c["weight_decay_norm"] * (spectral + bn)
        self.opt.step(torch.autograd.grad(
            loss, [self.w[k] for k in self.keys], allow_unused=True))
        return {"loss": loss.detach(), "recon": recon.detach().mean(),
                "kl": kl.detach().sum(1).mean(),
                "spectral": spectral.detach(), "bn": bn.detach()}


# -- counts -----------------------------------------------------------------------

def _counted(c: Dict) -> List[Dict]:
    return [l for l in layers(c)
            if l["kind"] in ("conv", "linear") and not l.get("derived")]


def step_flops(c: Dict, costs) -> float:
    """FLOPs of the convolutions (a depthwise one counted with one input
    channel) and dense layers of one step: each layer's forward, its weight
    gradient and its input gradient, but the stem's input gradient (the
    images need none); nothing recomputed."""
    from . import celeba

    b = c["batch_size_train"]
    total = 0.0
    for l in _counted(c):
        f = celeba.forward_flops(l, b, costs)
        total += f * (2 if l["name"] == f"{P}.stem" else 3)
    return total


def fused_linear_launches(c: Dict):
    """(M, K, N, x bytes) of the step's dense forward calls: each cell's
    squeeze-excitation, two bf16 layers."""
    b = c["batch_size_train"]
    return [(b, l["fin"], l["fout"], 2) for l in _counted(c)
            if l["kind"] == "linear"]


def batchnorm_calls(c: Dict):
    """(rows, C, activation) of every BatchNorm call of a step, forward and
    backward each once: rows = batch · pixels."""
    b = c["batch_size_train"]
    return [(b * l["hw"] ** 2, l["features"], l["act"])
            for l in layers(c) if l["kind"] == "bn"]
