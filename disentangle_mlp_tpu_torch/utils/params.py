"""Parameter bridge between the JAX package's flax trees and the port's
modules, both ways, so the two frameworks can start from one init.

The port's modules carry the flax modules' attribute names (``conv1``,
``mu_fc1``, ``pre_bn`` ...), so a tree path names a submodule, and the leaf
layout follows the submodule's type:

- Conv            HWIO → OIHW: ``transpose(3, 2, 0, 1)``.
- ConvTranspose   the JAX kernel correlates an input-dilated map, torch's
                  convolves: HWIO → (in, out, kh, kw) is
                  ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``.
- Linear          (in, out) → (out, in). Both frameworks flatten conv maps
                  in (H, W, C) order, so no permutation is needed.
- BatchNorm       ``{"bn": {"scale", "bias"}}`` → ``weight``/``bias``;
                  batch stats ``{"bn": {"mean", "var"}}`` →
                  ``running_mean``/``running_var``.

Trees are nested dicts of numpy arrays on both sides (``to_numpy_tree`` turns
a flax tree of device arrays into one).

The FID InceptionV3 (eval/inception.py) has no flax module: its tree is
``{name: {"kernel": HWIO, "bias"}}`` (Mixed blocks one level deeper), and
:func:`inception_from_jax` / :func:`inception_to_jax` move it into a new
``InceptionV3`` (OIHW weights) and back.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..eval.inception import FoldedConv, InceptionV3
from ..models.layers import BatchNorm, Conv, ConvTranspose, Linear

Tree = Dict[str, Any]


def to_numpy_tree(tree) -> Tree:
    """Nested mapping of arrays (flax FrozenDict/dict of jax or numpy
    arrays) → nested dict of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _kernel_to_torch(module: nn.Module, kernel: np.ndarray) -> np.ndarray:
    if isinstance(module, (Conv, FoldedConv)):
        return kernel.transpose(3, 2, 0, 1)
    if isinstance(module, ConvTranspose):
        return kernel[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, Linear):
        return kernel.T
    raise TypeError(f"no kernel layout for {type(module).__name__}")


def _kernel_to_jax(module: nn.Module, weight: np.ndarray) -> np.ndarray:
    if isinstance(module, (Conv, FoldedConv)):
        return weight.transpose(2, 3, 1, 0)
    if isinstance(module, ConvTranspose):
        return weight.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(module, Linear):
        return weight.T
    raise TypeError(f"no kernel layout for {type(module).__name__}")


def _copy(dst: torch.Tensor, src: np.ndarray, where: str) -> None:
    src = np.array(src, np.float32)  # a writable, contiguous copy
    if tuple(dst.shape) != src.shape:
        raise ValueError(f"{where}: shape {src.shape} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def from_jax(module: nn.Module, params: Tree, batch_stats: Tree = None
             ) -> None:
    """Load flax ``params`` (and ``batch_stats``) into ``module`` in place.
    Every leaf must find its tensor and every tensor must be written."""
    written = set()

    def walk(mod: nn.Module, p: Tree, s: Tree, path: str):
        if isinstance(mod, BatchNorm):
            for name, leaf in (("weight", p["bn"]["scale"]),
                               ("bias", p["bn"]["bias"])):
                _copy(getattr(mod, name), leaf, f"{path}.{name}")
                written.add(f"{path}.{name}")
            if s is not None:
                _copy(mod.running_mean, s["bn"]["mean"], path)
                _copy(mod.running_var, s["bn"]["var"], path)
            return
        if "kernel" in p:
            _copy(mod.weight, _kernel_to_torch(mod, np.asarray(p["kernel"])),
                  f"{path}.weight")
            _copy(mod.bias, p["bias"], f"{path}.bias")
            written.update({f"{path}.weight", f"{path}.bias"})
            return
        for name, sub in p.items():
            walk(getattr(mod, name), sub,
                 None if s is None else s.get(name), f"{path}.{name}")

    walk(module, params, batch_stats, "")
    expected = {"." + n for n, _ in module.named_parameters()}
    if written != expected:
        raise ValueError(f"parameters not written: "
                         f"{sorted(expected - written)}")


def to_jax(module: nn.Module) -> Tuple[Tree, Tree]:
    """The inverse of :func:`from_jax`: (params, batch_stats) flax-layout
    trees of float32 numpy arrays."""

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def walk(mod: nn.Module) -> Tuple[Tree, Tree]:
        if isinstance(mod, BatchNorm):
            return ({"bn": {"scale": arr(mod.weight), "bias": arr(mod.bias)}},
                    {"bn": {"mean": arr(mod.running_mean),
                            "var": arr(mod.running_var)}})
        if isinstance(mod, (Conv, ConvTranspose, Linear, FoldedConv)):
            kernel = _kernel_to_jax(mod, arr(mod.weight))
            return ({"kernel": np.ascontiguousarray(kernel),
                     "bias": arr(mod.bias)}, {})
        params, stats = {}, {}
        for name, child in mod.named_children():
            p, s = walk(child)
            params[name] = p
            if s:
                stats[name] = s
        return params, stats

    return walk(module)


def inception_from_jax(params: Tree) -> InceptionV3:
    """A new float32 :class:`InceptionV3` on the CPU holding the Inception
    params tree (HWIO kernels → OIHW weights)."""
    model = InceptionV3()
    from_jax(model, params)
    return model.eval()


def inception_to_jax(model: InceptionV3) -> Tree:
    """The inverse of :func:`inception_from_jax`: the params tree."""
    return to_jax(model)[0]
