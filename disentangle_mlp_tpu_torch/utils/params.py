"""Parameter bridge between the JAX package's flax trees and the port's
modules, both ways, so the two frameworks can start from one init and read
each other's checkpoints.

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
                  ``running_mean``/``running_var``. A FlaxBatchNorm (the
                  families' raw ``flax.linen.BatchNorm``) has no ``bn``
                  level: ``BatchNorm_k/{scale, bias}``, ``{mean, var}``.
- A kernel layer without a bias (the families' ResNet, birds convs and
  transposed convs) has only its ``kernel`` leaf.

The families' modules carry flax's compact auto-names (``Conv_0``,
``BatchNorm_1``, ``BasicBlock_3``, ``_CT_5`` ...) as attribute names, so
the same walk gives their trees.

One walk over the module (:func:`_param_leaves`) gives every parameter its
flax path and layout. :func:`from_jax` / :func:`to_jax` move parameters
and statistics as float32 numpy trees (``to_numpy_tree`` turns a flax tree
of device arrays into one); :func:`flax_tree` / :func:`load_flax_tree`
move torch tensors of any dtype and device, for a parameter or for any
tensor shaped like it, such as an Adam moment. :func:`adam_to_jax` /
:func:`adam_from_jax` use them for optax's Adam state, so the port's flat
``mu``/``nu`` lists take the layout of the parameters they belong to.

The FID InceptionV3 (eval/inception.py) has no flax module: its tree is
``{name: {"kernel": HWIO, "bias"}}`` (Mixed blocks one level deeper), and
:func:`inception_from_jax` / :func:`inception_to_jax` move it into a new
``InceptionV3`` (OIHW weights) and back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..eval.inception import FoldedConv, InceptionV3
from ..models.layers import (BatchNorm, Conv, ConvTranspose, FlaxBatchNorm,
                             Linear)

Tree = Dict[str, Any]
Path = Tuple[str, ...]
Leaf = Optional[Callable[[torch.Tensor], torch.Tensor]]
_KERNEL_LAYERS = (Conv, ConvTranspose, Linear, FoldedConv)


def to_numpy_tree(tree) -> Tree:
    """Nested mapping of arrays (flax FrozenDict/dict of jax or numpy
    arrays) → nested dict of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _kernel_to_torch(module: nn.Module, kernel: torch.Tensor) -> torch.Tensor:
    if isinstance(module, (Conv, FoldedConv)):
        return kernel.permute(3, 2, 0, 1)
    if isinstance(module, ConvTranspose):
        return kernel.flip(0, 1).permute(2, 3, 0, 1)
    if isinstance(module, Linear):
        return kernel.t()
    raise TypeError(f"no kernel layout for {type(module).__name__}")


def _kernel_to_jax(module: nn.Module, weight: torch.Tensor) -> torch.Tensor:
    if isinstance(module, (Conv, FoldedConv)):
        return weight.permute(2, 3, 1, 0)
    if isinstance(module, ConvTranspose):
        return weight.permute(2, 3, 0, 1).flip(0, 1)
    if isinstance(module, Linear):
        return weight.t()
    raise TypeError(f"no kernel layout for {type(module).__name__}")


def _layers(module: nn.Module, path: Path = ()
            ) -> Iterator[Tuple[Path, nn.Module]]:
    """(flax path, layer) of every BatchNorm and kernel layer, in module
    order; the path is the chain of attribute names."""
    if isinstance(module, (BatchNorm,) + _KERNEL_LAYERS):
        yield path, module
        return
    for name, child in module.named_children():
        yield from _layers(child, path + (name,))


def _bn_path(path: Path, mod: BatchNorm) -> Path:
    return path if isinstance(mod, FlaxBatchNorm) else path + ("bn",)


def _param_leaves(module: nn.Module) -> Iterator[
        Tuple[Path, torch.Tensor, Optional[nn.Module]]]:
    """(flax path, parameter, kernel layer or None) for every parameter;
    the layer is given where the leaf takes its kernel layout."""
    for path, mod in _layers(module):
        if isinstance(mod, BatchNorm):
            yield _bn_path(path, mod) + ("scale",), mod.weight, None
            yield _bn_path(path, mod) + ("bias",), mod.bias, None
        else:
            yield path + ("kernel",), mod.weight, mod
            if mod.bias is not None:
                yield path + ("bias",), mod.bias, None


def _stat_leaves(module: nn.Module) -> Iterator[Tuple[Path, torch.Tensor]]:
    for path, mod in _layers(module):
        if isinstance(mod, BatchNorm):
            yield _bn_path(path, mod) + ("mean",), mod.running_mean
            yield _bn_path(path, mod) + ("var",), mod.running_var


def _put(tree: Tree, path: Path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: Tree, path: Path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise KeyError("/".join(path))
        tree = tree[key]
    return tree


def _leaf_paths(tree, path: Path = ()) -> Iterator[Path]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path


def _load(leaves, tree: Tree, convert: Callable, what: str) -> None:
    """Copy ``tree``'s leaf at each path into its tensor: every tensor
    must find its leaf, every leaf its tensor, and shapes must agree."""
    leaves = list(leaves)
    missing, srcs = [], []
    for path, dst, layer in leaves:
        try:
            srcs.append(convert(_get(tree, path), layer))
        except KeyError:
            missing.append("/".join(path))
    if missing:
        raise ValueError(f"{what} not written: {missing}")
    extra = set(_leaf_paths(tree)) - {path for path, _, _ in leaves}
    if extra:
        raise ValueError(f"{what}: leaves {sorted(map('/'.join, extra))} "
                         f"match no tensor of the module")
    with torch.no_grad():
        for (path, dst, _), src in zip(leaves, srcs):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{what} {'/'.join(path)}: shape "
                                 f"{tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


def _numpy_in(leaf, layer: Optional[nn.Module]) -> torch.Tensor:
    t = torch.from_numpy(np.array(leaf, np.float32))  # writable copy
    return t if layer is None else _kernel_to_torch(layer, t)


def from_jax(module: nn.Module, params: Tree, batch_stats: Tree = None
             ) -> None:
    """Load flax ``params`` (and ``batch_stats``) of numpy or jax arrays
    into ``module`` in place. Every leaf must find its tensor and every
    tensor must be written."""
    _load(_param_leaves(module), params, _numpy_in, "parameters")
    if batch_stats is not None:
        _load(((p, t, None) for p, t in _stat_leaves(module)), batch_stats,
              _numpy_in, "batch statistics")


def to_jax(module: nn.Module) -> Tuple[Tree, Tree]:
    """The inverse of :func:`from_jax`: (params, batch_stats) flax-layout
    trees of float32 numpy arrays."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.detach().float().cpu().numpy())

    return _map(flax_tree(module), arr), _map(stats_tree(module), arr)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def flax_tree(module: nn.Module, leaf: Leaf = None) -> Tree:
    """``module``'s params tree in the flax layout, as torch tensors on the
    module's device: each parameter, or ``leaf(parameter)`` (a tensor
    shaped like it, e.g. its Adam moment), in its own dtype, kernels
    transposed and flipped as their layer needs."""
    tree: Tree = {}
    for path, p, layer in _param_leaves(module):
        t = (p if leaf is None else leaf(p)).detach()
        if layer is not None:
            t = _kernel_to_jax(layer, t)
        _put(tree, path, t.contiguous())
    return tree


def stats_tree(module: nn.Module) -> Tree:
    """``module``'s batch_stats tree (running mean and variance)."""
    tree: Tree = {}
    for path, t in _stat_leaves(module):
        _put(tree, path, t.detach())
    return tree


def _tensor_in(leaf: torch.Tensor, layer: Optional[nn.Module]
               ) -> torch.Tensor:
    return leaf if layer is None else _kernel_to_torch(layer, leaf)


def load_flax_tree(module: nn.Module, tree: Tree, leaf: Leaf = None,
                   what: str = "parameters") -> None:
    """The inverse of :func:`flax_tree`: copy a flax-layout tree of torch
    tensors into each parameter, or into ``leaf(parameter)``; ``copy_``
    casts and moves each leaf to its destination's dtype and device."""
    _load(((path, p if leaf is None else leaf(p), layer)
           for path, p, layer in _param_leaves(module)),
          tree, _tensor_in, what)


def load_stats_tree(module: nn.Module, tree: Tree) -> None:
    _load(((p, t, None) for p, t in _stat_leaves(module)), tree, _tensor_in,
          "batch statistics")


def _moment_index(opt, module: nn.Module) -> Dict[int, int]:
    index = {id(p): i for i, p in enumerate(opt.params)}
    if index.keys() != {id(p) for p in module.parameters()}:
        raise ValueError("the optimizer's parameters are not the module's")
    return index


def adam_to_jax(opt, module: nn.Module) -> Tree:
    """optax's Adam state for ``opt`` (train.common.Adam) over ``module``'s
    parameters, as flax serializes it: ``{"0": {"count": int32 0-d, "mu":
    tree, "nu": tree}, "1": {}}`` (scale_by_adam's state, then the empty
    state of the learning-rate scale), moments in the flax layout."""
    index = _moment_index(opt, module)
    return {"0": {
        "count": opt.count.detach(),
        "mu": flax_tree(module, lambda p: opt.mu[index[id(p)]]),
        "nu": flax_tree(module, lambda p: opt.nu[index[id(p)]]),
    }, "1": {}}


def adam_from_jax(opt, module: nn.Module, state: Tree) -> None:
    """The inverse of :func:`adam_to_jax`: the step count and both moments
    copied into ``opt``'s tensors in place (a CUDA graph of the step holds
    their addresses), each moment cast to the optimizer's moment dtype."""
    index = _moment_index(opt, module)
    s = state["0"]
    load_flax_tree(module, s["mu"], lambda p: opt.mu[index[id(p)]],
                   "Adam mu")
    load_flax_tree(module, s["nu"], lambda p: opt.nu[index[id(p)]],
                   "Adam nu")
    with torch.no_grad():
        opt.count.copy_(torch.as_tensor(s["count"]).reshape(()))


def inception_from_jax(params: Tree) -> InceptionV3:
    """A new float32 :class:`InceptionV3` on the CPU holding the Inception
    params tree (HWIO kernels → OIHW weights)."""
    model = InceptionV3()
    from_jax(model, params)
    return model.eval()


def inception_to_jax(model: InceptionV3) -> Tree:
    """The inverse of :func:`inception_from_jax`: the params tree."""
    return to_jax(model)[0]
