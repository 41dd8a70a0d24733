"""Layer tables, initial weights and the passes of a step for the CelebA
64x64 networks of :mod:`nets`, shared by the beta-VAE-GAN and the VAE
references. Sizes come from a configuration file's keys (the reference
architecture's widths, or smaller ones in the CPU tests).

A layer is a dict: ``name``, ``kind`` (``conv``, ``conv_t``, ``linear``,
``bn``) and its sizes (``cin``, ``cout``, ``k``, ``stride``, ``hw_in`` of a
convolution; ``fin``, ``fout`` of a dense layer; ``features`` of a
BatchNorm).

Initial weights follow the reference's ``weights_init`` (model.py:8-13):
convolution kernels N(0, 0.02^2), BatchNorm scales N(1, 0.02^2) and
shifts 0; dense layers and convolution biases PyTorch's default
U(+-1/sqrt(fan_in)) (a transposed convolution's fan_in is out * k * k, as
PyTorch computes it from its weight). They are drawn on the device from
the seed in two calls, one for every normal and one for every uniform.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import nets

Layer = Dict


def _conv(name, kind, cin, cout, stride, hw_in, k=5) -> Layer:
    return {"name": name, "kind": kind, "cin": cin, "cout": cout, "k": k,
            "stride": stride, "hw_in": hw_in}


def _linear(name, fin, fout) -> Layer:
    return {"name": name, "kind": "linear", "fin": fin, "fout": fout}


def _bn(name, features) -> Layer:
    return {"name": name, "kind": "bn", "features": features}


def encoder_layers(p: str, c: Dict) -> List[Layer]:
    rs, img = c["representation_size"], c["img_size"]
    chans = [c["input_channels"], rs, rs * 2, rs * 4]
    out: List[Layer] = []
    for i in (1, 2, 3):
        out += [_conv(f"{p}.conv{i}", "conv", chans[i - 1], chans[i], 2,
                      img >> (i - 1)),
                _bn(f"{p}.bn{i}", chans[i])]
    flat = rs * 4 * (img // 8) ** 2
    for head in ("mu", "lv"):
        out += [_linear(f"{p}.{head}_fc1", flat, c["head_width"]),
                _bn(f"{p}.{head}_bn", c["head_width"]),
                _linear(f"{p}.{head}_fc2", c["head_width"], c["n_hidden"])]
    return out


def decoder_layers(p: str, c: Dict) -> List[Layer]:
    ch, h, _ = c["n_z"]
    c1, c2, c3 = c["decoder_channels"]
    out = [_linear(f"{p}.preprocess", c["n_hidden"], ch * h * h),
           _bn(f"{p}.pre_bn", ch * h * h)]
    chans = [ch, c1, c2, c3]
    for i in (1, 2, 3):
        out += [_conv(f"{p}.deconv{i}", "conv_t", chans[i - 1], chans[i], 2,
                      h << (i - 1)),
                _bn(f"{p}.dbn{i}", chans[i])]
    return out + [_conv(f"{p}.deconv4", "conv_t", c3, c["input_channels"], 1,
                        h << 3)]


def discriminator_layers(p: str, c: Dict) -> List[Layer]:
    img = c["img_size"]
    chans = [c["input_channels"]] + list(c["disc_channels"])
    out: List[Layer] = []
    hw = img
    for i, s in ((1, 1), (2, 2), (3, 2), (4, 2)):
        out += [_conv(f"{p}.conv{i}", "conv", chans[i - 1], chans[i], s, hw),
                _bn(f"{p}.bn{i}", chans[i])]
        hw //= s
    flat = chans[4] * (img // 8) ** 2
    return out + [_linear(f"{p}.lth_features", flat, c["disc_feature_dim"]),
                  _linear(f"{p}.sigmoid_output", c["disc_feature_dim"], 1)]


def _shapes(layer: Layer):
    """{suffix: (shape, draw, fan_in)} of a layer's tensors; draw is
    "normal", "uniform", "zeros", "ones" or "bn_scale"."""
    kind = layer["kind"]
    if kind == "bn":
        f = layer["features"]
        return {"weight": ((f,), "bn_scale", 0), "bias": ((f,), "zeros", 0),
                "running_mean": ((f,), "zeros", 0),
                "running_var": ((f,), "ones", 0)}
    if kind == "linear":
        fin, fout = layer["fin"], layer["fout"]
        return {"weight": ((fout, fin), "uniform", fin),
                "bias": ((fout,), "uniform", fin)}
    cin, cout, k = layer["cin"], layer["cout"], layer["k"]
    if kind == "conv":
        return {"weight": ((cout, cin, k, k), "normal", 0),
                "bias": ((cout,), "uniform", cin * k * k)}
    return {"weight": ((cin, cout, k, k), "normal", 0),
            "bias": ((cout,), "uniform", cout * k * k)}


def init_weights(layers: List[Layer], seed: int, device) -> nets.Weights:
    """Every tensor of ``layers``, float32 on ``device``, from ``seed``.
    Parameters require grad; running statistics do not."""
    plan = [(f"{l['name']}.{suffix}", spec)
            for l in layers for suffix, spec in _shapes(l).items()]

    def count(draws):
        return sum(torch.Size(s[0]).numel() for _, s in plan
                   if s[1] in draws)

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    normal = torch.randn(count(("normal", "bn_scale")), generator=gen,
                         device=device)
    uniform = torch.rand(count(("uniform",)), generator=gen, device=device)
    w: nets.Weights = {}
    i_n = i_u = 0
    for key, (shape, draw, fan_in) in plan:
        n = torch.Size(shape).numel()
        if draw in ("normal", "bn_scale"):
            t = normal[i_n:i_n + n].view(shape) * 0.02
            i_n += n
            if draw == "bn_scale":
                t = t + 1.0
        elif draw == "uniform":
            bound = fan_in ** -0.5
            t = (uniform[i_u:i_u + n].view(shape) * 2 - 1) * bound
            i_u += n
        else:
            t = (torch.zeros if draw == "zeros" else torch.ones)(
                shape, device=device)
        w[key] = t.clone().requires_grad_(not key.endswith(
            ("running_mean", "running_var")))
    return w


def params(w: nets.Weights, prefix: str) -> List[str]:
    """The parameter keys under ``prefix``, in table order."""
    return [k for k, t in w.items()
            if k.startswith(prefix + ".") and t.requires_grad]


def stats(w: nets.Weights) -> List[str]:
    return [k for k, t in w.items() if not t.requires_grad]


# -- operation counts ---------------------------------------------------------

def forward_flops(layer: Layer, batch: int, costs) -> float:
    """FLOPs of one forward pass of ``layer`` (BatchNorm counted as 0:
    only convolutions and dense layers are counted)."""
    kind = layer["kind"]
    if kind == "linear":
        return costs.linear_flops(batch, layer["fin"], layer["fout"])
    if kind == "conv":
        hw_out = layer["hw_in"] // layer["stride"]
        return costs.conv2d_flops(batch, layer["cin"], layer["cout"],
                                  layer["k"], hw_out, hw_out)
    if kind == "conv_t":
        return costs.conv_transpose2d_flops(batch, layer["cin"],
                                            layer["cout"], layer["k"],
                                            layer["hw_in"], layer["hw_in"])
    return 0.0


def passes_flops(layers: List[Layer], batch: int, costs, fwd: int,
                 wgrad: int, dgrad: int, first_dgrad: int) -> float:
    """FLOPs of ``fwd`` forward passes of a network, ``wgrad`` weight
    gradients of each layer and ``dgrad`` input gradients of each layer but
    the first, which takes ``first_dgrad`` (autograd computes an input
    gradient only where something upstream needs it). A gradient costs
    what the forward pass costs."""
    counted = [l for l in layers if l["kind"] != "bn"]
    total = 0.0
    for i, l in enumerate(counted):
        f = forward_flops(l, batch, costs)
        total += f * (fwd + wgrad + (first_dgrad if i == 0 else dgrad))
    return total
