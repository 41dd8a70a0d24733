"""The benchmark's weights in the program's checkpoint layout, and the
program's state read back under the benchmark's names.

The program loads a state through its experiment's ``load_states``, which
takes the JAX package's checkpoint layout: per network ``{"params",
"batch_stats", "opt_state"}``, flax trees keyed by the modules' attribute
names, convolution kernels HWIO, transposed-convolution kernels HWIO of
the flipped kernel, dense kernels (in, out), BatchNorm leaves under
``bn/{scale, bias}`` and ``bn/{mean, var}``, optax Adam as ``{"0":
{"count", "mu", "nu"}, "1": {}}``. The benchmark's tensors are in torch
layouts under the program's parameter names (``vae.encoder.conv1.weight``
...), as :mod:`reference.celeba` makes them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from reference import celeba

BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
             "running_var": "var"}


def _kernel(kind: str, t: torch.Tensor) -> torch.Tensor:
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "conv_t":
        return t.permute(2, 3, 0, 1).flip(0, 1)
    return t.t()


def trees(w: Dict[str, torch.Tensor], layers: Iterable[celeba.Layer],
          prefix: str):
    """(params, batch_stats) flax trees of the layers under ``prefix``."""
    params: Dict = {}
    stats: Dict = {}
    for layer in layers:
        name = layer["name"]
        if not name.startswith(prefix + "."):
            continue
        path = name[len(prefix) + 1:].split(".")
        node_p, node_s = params, stats
        for key in path:
            node_p = node_p.setdefault(key, {})
        if layer["kind"] == "bn":
            for key in path:
                node_s = node_s.setdefault(key, {})
            node_p["bn"] = {BN_LEAVES[s]: w[f"{name}.{s}"].detach()
                            for s in ("weight", "bias")}
            node_s["bn"] = {BN_LEAVES[s]: w[f"{name}.{s}"].detach()
                            for s in ("running_mean", "running_var")}
        else:
            node_p["kernel"] = _kernel(layer["kind"],
                                       w[name + ".weight"].detach())
            node_p["bias"] = w[name + ".bias"].detach()
    return params, stats


def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def fresh_adam(params) -> Dict:
    device = next(iter(_leaves(params))).device
    return {"0": {"count": torch.zeros((), dtype=torch.int32, device=device),
                  "mu": zeros_like_tree(params),
                  "nu": zeros_like_tree(params)}, "1": {}}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def network_state(w, layers, prefix: str, opt_state=None) -> Dict:
    params, stats = trees(w, layers, prefix)
    return {"params": params, "batch_stats": stats,
            "opt_state": fresh_adam(params) if opt_state is None
            else opt_state}


def named(modules: Dict[str, torch.nn.Module]) -> Dict:
    """{"params", "stats", "moments"}: the program's parameters, running
    statistics and Adam first moments under the benchmark's names.
    ``modules`` maps a name prefix to the experiment's module."""
    params, stats, ids = {}, {}, {}
    for prefix, mod in modules.items():
        for n, p in mod.named_parameters():
            params[f"{prefix}.{n}"] = p
            ids[id(p)] = f"{prefix}.{n}"
        for n, b in mod.named_buffers():
            stats[f"{prefix}.{n}"] = b
    return {"params": params, "stats": stats, "ids": ids}


def moments(optimizers: List, ids: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """Each parameter's Adam first moment, from the program's optimizers
    (each holds ``params`` and ``mu`` lists)."""
    out = {}
    for opt in optimizers:
        for p, m in zip(opt.params, opt.mu):
            out[ids[id(p)]] = m
    return out
