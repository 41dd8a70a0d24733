"""Migrate the reference's PyTorch ``.tar`` checkpoints into the port's
checkpoint format, which is the JAX package's (a copy of
disentangle_mlp_tpu/utils/torch_compat.py: the port imports nothing of the
JAX package, so it keeps its own).

The reference saves per-epoch torch checkpoints (reference:
new_betavaegan.py:221-228 {epoch, encoder_decoder_model,
discriminator_model, …}; new_vae.py:88-91 {epoch, VAE_model, optimizer};
new_gan.py:169-174 {epoch, netG, netD, …}). A user can convert those
(cli/convert.py) and resume with ``--load_path`` as if the run had always
been here. The result is the flax-layout tree of the JAX package's
checkpoints, numpy float32 leaves, which utils/params.py moves into the
port's modules.

Weight-layout mapping (held against torch modules built with the
reference's exact state_dict key names):

- Conv2d          OIHW → HWIO transpose.
- ConvTranspose2d (in, out, kh, kw) → transpose to (kh, kw, in, out) then
                  flip both spatial axes: torch conv-transpose convolves
                  the kernel, the JAX layout's dilated convolution
                  correlates (utils/params.py ConvTranspose undoes it).
- Linear          (out, in) → (in, out) transpose.
- Flatten seams   torch flattens conv maps channel-first (C,H,W); the
                  JAX layout (and the port's models) flatten (H,W,C) — at every
                  Linear that touches a flattened conv map, the flat axis
                  is re-indexed with the CHW→HWC permutation. Affected:
                  encoder μ/logσ² heads and the discriminator's
                  ``lth_features`` (input side), the decoder's
                  ``preprocess`` Linear + its BatchNorm1d (output side,
                  reshaped to (C,H,W) there vs (H,W,C) here).
- BatchNorm       weight→scale, bias→bias, running_mean/var→batch_stats;
                  ``num_batches_tracked`` is dropped (unused by the
                  math).

Optimizer moments are NOT migrated: torch Adam state is keyed by opaque
parameter ids and its (β₁, β₂, step) tuple is resumable only
approximately; the converted checkpoint carries fresh optimizer state and
the original epoch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Tree = Dict[str, dict]


def to_numpy(t) -> np.ndarray:
    """torch.Tensor or ndarray → float32 ndarray."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def conv_kernel_hwio(w) -> np.ndarray:
    """torch Conv2d weight OIHW → flax HWIO."""
    return to_numpy(w).transpose(2, 3, 1, 0)


_np = to_numpy


def strip_module_prefix(sd: dict) -> dict:
    """Drop DataParallel's 'module.' prefix (the reference saves netG/netD
    state dicts possibly wrapped — new_gan.py:51-53,171-172)."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[i] = CHW flat index of the i-th element in HWC flat order."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def _conv(sd: dict, key: str) -> Tree:
    return {"kernel": conv_kernel_hwio(sd[f"{key}.weight"]),
            "bias": _np(sd[f"{key}.bias"])}


def _convt(sd: dict, key: str) -> Tree:
    # torch ConvT weight is (in, out, kh, kw) — NOT conv's OIHW, so this is
    # transpose(2, 3, 0, 1), not conv_kernel_hwio's (2, 3, 1, 0)
    w = _np(sd[f"{key}.weight"]).transpose(2, 3, 0, 1)  # (kh, kw, in, out)
    return {"kernel": np.ascontiguousarray(w[::-1, ::-1]),
            "bias": _np(sd[f"{key}.bias"])}


def _linear(sd: dict, key: str, in_perm: Optional[np.ndarray] = None,
            out_perm: Optional[np.ndarray] = None) -> Tree:
    k = _np(sd[f"{key}.weight"]).T  # (in, out)
    b = _np(sd[f"{key}.bias"])
    if in_perm is not None:
        k = k[in_perm, :]
    if out_perm is not None:
        k, b = k[:, out_perm], b[out_perm]
    return {"kernel": k, "bias": b}


def _bn(sd: dict, key: str, perm: Optional[np.ndarray] = None
        ) -> Tuple[Tree, Tree]:
    take = lambda name: (_np(sd[f"{key}.{name}"]) if perm is None
                         else _np(sd[f"{key}.{name}"])[perm])
    params = {"bn": {"scale": take("weight"), "bias": take("bias")}}
    stats = {"bn": {"mean": take("running_mean"), "var": take("running_var")}}
    return params, stats


def convert_decoder_state_dict(sd: dict, n_z: Sequence[int] = (256, 8, 8)
                               ) -> Tuple[Tree, Tree]:
    """Reference VAE decoder / Generator_celeba keys (model.py:490-509,
    331-360: preprocess, deconv1..4, act1..3) → CelebaDecoder tree."""
    ch, h, w = n_z
    perm = chw_to_hwc_perm(ch, h, w)
    params: Tree = {"preprocess": _linear(sd, "preprocess.0", out_perm=perm)}
    stats: Tree = {}
    params["pre_bn"], stats["pre_bn"] = _bn(sd, "preprocess.1", perm=perm)
    for i in (1, 2, 3):
        params[f"deconv{i}"] = _convt(sd, f"deconv{i}")
        params[f"dbn{i}"], stats[f"dbn{i}"] = _bn(sd, f"act{i}.0")
    params["deconv4"] = _convt(sd, "deconv4")
    return params, stats


def convert_encoder_state_dict(sd: dict, representation_size: int = 64,
                               feature_hw: int = 8) -> Tuple[Tree, Tree]:
    """Reference VAE encoder keys (model.py:449-471: features.{0,1,3,4,6,7},
    x_to_mu.*, x_to_logvar.*) → CelebaEncoder tree."""
    c = representation_size * 4
    perm = chw_to_hwc_perm(c, feature_hw, feature_hw)
    params: Tree = {}
    stats: Tree = {}
    for i, (conv_k, bn_k) in enumerate((("features.0", "features.1"),
                                        ("features.3", "features.4"),
                                        ("features.6", "features.7")), 1):
        params[f"conv{i}"] = _conv(sd, conv_k)
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, bn_k)
    for ours, theirs in (("mu", "x_to_mu"), ("lv", "x_to_logvar")):
        params[f"{ours}_fc1"] = _linear(sd, f"{theirs}.0", in_perm=perm)
        params[f"{ours}_bn"], stats[f"{ours}_bn"] = _bn(sd, f"{theirs}.1")
        params[f"{ours}_fc2"] = _linear(sd, f"{theirs}.3")
    return params, stats


def convert_vae_state_dict(sd: dict, representation_size: int = 64,
                           n_z: Sequence[int] = (256, 8, 8),
                           feature_hw: int = 8) -> Tuple[Tree, Tree]:
    """Full reference ``VAE`` state_dict → the VAE's {params, batch_stats}."""
    sd = strip_module_prefix(sd)
    enc_p, enc_s = convert_encoder_state_dict(sd, representation_size,
                                              feature_hw=feature_hw)
    dec_p, dec_s = convert_decoder_state_dict(sd, n_z)
    return ({"encoder": enc_p, "decoder": dec_p},
            {"encoder": enc_s, "decoder": dec_s})


def convert_discriminator_state_dict(sd: dict,
                                     flat_shape: Sequence[int] = (256, 8, 8)
                                     ) -> Tuple[Tree, Tree]:
    """Reference ``Discriminator_celeba`` state_dict (model.py:381-408:
    convs.{0,1,3,4,6,7,9,10}, lth_features.0, sigmoid_output.0) → our
    DiscriminatorCeleba tree. ``flat_shape`` = the (C, H, W) of the last
    conv map feeding ``lth_features`` ((256, 8, 8) at full size)."""
    sd = strip_module_prefix(sd)
    perm = chw_to_hwc_perm(*flat_shape)
    params: Tree = {}
    stats: Tree = {}
    for i in range(4):
        params[f"conv{i + 1}"] = _conv(sd, f"convs.{3 * i}")
        params[f"bn{i + 1}"], stats[f"bn{i + 1}"] = _bn(sd, f"convs.{3 * i + 1}")
    params["lth_features"] = _linear(sd, "lth_features.0", in_perm=perm)
    params["sigmoid_output"] = _linear(sd, "sigmoid_output.0")
    return params, stats


def load_torch_file(path: str) -> dict:
    import torch

    # weights_only: no arbitrary unpickling from untrusted checkpoints
    # (reference .tars are plain dicts of tensors and ints)
    return torch.load(path, map_location="cpu", weights_only=True)


def convert_reference_checkpoint(path: str, model: str, cfg) -> dict:
    """Read a reference ``.tar`` checkpoint and return
    {'epoch': int, '<state name>': {'params': ..., 'batch_stats': ...}}
    keyed exactly like the checkpoint states ('model' for vae,
    'g'/'d' for gan, 'eg'/'d' for betavaegan)."""
    ckpt = load_torch_file(path)
    rs, n_z = cfg.representation_size, tuple(cfg.n_z)
    # flattened-conv-map shapes at the Linear seams: encoder/discriminator
    # bottlenecks are (last conv width, img/8, img/8) — (256, 8, 8) at the
    # reference's full size, where they coincide with n_z
    hw = cfg.img_size // 8
    d_flat = (cfg.disc_channels[-1], hw, hw)
    out = {"epoch": int(ckpt.get("epoch", 0))}
    if model == "vae":
        p, s = convert_vae_state_dict(ckpt["VAE_model"], rs, n_z,
                                      feature_hw=hw)
        out["model"] = {"params": p, "batch_stats": s}
    elif model == "gan":
        p, s = convert_decoder_state_dict(
            strip_module_prefix(ckpt["netG"]), n_z)
        out["g"] = {"params": p, "batch_stats": s}
        p, s = convert_discriminator_state_dict(ckpt["netD"], d_flat)
        out["d"] = {"params": p, "batch_stats": s}
    elif model in ("betavaegan", "vaegan"):
        p, s = convert_vae_state_dict(ckpt["encoder_decoder_model"], rs,
                                      n_z, feature_hw=hw)
        out["eg"] = {"params": p, "batch_stats": s}
        p, s = convert_discriminator_state_dict(
            ckpt["discriminator_model"], d_flat)
        out["d"] = {"params": p, "batch_stats": s}
    else:
        raise ValueError(f"unknown model {model!r}")
    return out
