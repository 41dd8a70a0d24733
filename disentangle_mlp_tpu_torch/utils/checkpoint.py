"""Checkpoint save/restore of the port, in the JAX package's file format
(disentangle_mlp_tpu/utils/checkpoint.py), so a run started on one
framework resumes or is evaluated on the other.

A file is the msgpack (utils/msgpack.py) of ``{"epoch", "states": {name:
{"params", "batch_stats", "opt_state"}}}``, the names those of the JAX
package's experiments (``model`` for the VAE, ``g``/``d`` for the GAN,
``eg``/``d`` for the β-VAE-GAN), every tree in the flax layout and
``opt_state`` as optax writes its Adam (utils/params.py). The experiments'
``states()`` and ``load_states()`` make and take that dict. One file per
saved epoch under ``<save_path>/models/model_<epoch+1>``;
``rotate_checkpoints`` keeps the newest N.

``--checkpoint_save_dtype bfloat16`` stores the Adam moments in bf16 (cast
on the device, before the copy to the host); a restore casts them back to
the run's ``--optimizer_dtype`` and says so, as the JAX package does.
Parameters and batch statistics are never cast: a dtype that differs
there is an error.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from . import msgpack

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def save_checkpoint(path: str, epoch: int, states: Dict[str, Any],
                    opt_state_dtype: Optional[str] = None) -> str:
    """Write {epoch, states} to ``path`` atomically (temp file, rename).
    ``opt_state_dtype='bfloat16'`` stores the float32 optimizer leaves in
    bf16."""
    target = _DTYPES[opt_state_dtype or "float32"]

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(target) if t.dtype == torch.float32 else t

    out = {}
    for name, state in states.items():
        state = dict(state)
        if target != torch.float32:
            state["opt_state"] = _map(state["opt_state"], cast)
        out[name] = _map(state, lambda t: t.detach().cpu())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack.dump({"epoch": epoch, "states": out}, f)
    os.replace(tmp, path)
    return path


def _check_structure(template, tree, where: str) -> None:
    """Keys equal at every level and leaf shapes equal."""
    if isinstance(template, dict) != isinstance(tree, dict):
        raise ValueError(f"{where or '/'}: a map where a leaf is expected, "
                         f"or the other way round")
    if isinstance(template, dict):
        if set(template) != set(tree):
            raise ValueError(f"{where or '/'}: keys {sorted(tree)} differ "
                             f"from {sorted(template)}")
        for k in template:
            _check_structure(template[k], tree[k], f"{where}/{k}")
    elif tuple(template.shape) != tuple(tree.shape):
        raise ValueError(f"{where}: shape {tuple(tree.shape)} differs from "
                         f"{tuple(template.shape)}")


def _pairs(template, tree, where: str = ""):
    """(path, template leaf, leaf) over two trees of one structure."""
    if isinstance(template, dict):
        for k in template:
            yield from _pairs(template[k], tree[k], f"{where}/{k}")
    else:
        yield where, template, tree


def load_checkpoint(path: str, template_states: Dict[str, Any]
                    ) -> Tuple[int, Dict[str, Any]]:
    """The checkpoint at ``path`` as (epoch, states), checked against the
    structure of ``template_states`` (an experiment's ``states()``): the
    optimizer leaves cast to the template's dtypes, every tensor on the
    host."""
    raw = msgpack.load(path)
    epoch = int(raw["epoch"])
    states = raw["states"]
    try:
        _check_structure(template_states, states, "")
    except ValueError as e:
        raise ValueError(
            f"checkpoint {path!r} does not match the experiment's state "
            f"structure ({e!r}). Common cause: the run was trained under a "
            f"different --freeze_mode ('intent' keeps split {{dec, enc}} "
            f"Adam states, 'observed' one shared state) — pass the flag the "
            f"run was trained with.") from e
    for key, template in template_states.items():
        for part in ("params", "batch_stats"):
            for where, t, s in _pairs(template[part], states[key][part]):
                if s.dtype != t.dtype:
                    raise ValueError(
                        f"checkpoint {path!r}: {key}/{part}{where} is "
                        f"{_dtype_name(s.dtype)}, the experiment holds "
                        f"{_dtype_name(t.dtype)}")
        casts: Dict[str, int] = {}
        opt = states[key]["opt_state"]
        for _, t, s in _pairs(template["opt_state"], opt):
            if s.dtype != t.dtype:
                pair = f"{_dtype_name(s.dtype)}->{_dtype_name(t.dtype)}"
                casts[pair] = casts.get(pair, 0) + 1
        if casts:
            detail = ", ".join(f"{k} ×{v}" for k, v in sorted(casts.items()))
            print(f"[checkpoint] {path}: cast '{key}' opt_state leaves to "
                  f"the experiment's --optimizer_dtype ({detail})",
                  flush=True)
            states[key]["opt_state"] = _cast_like(template["opt_state"], opt)
    return epoch, states


def _cast_like(template, tree):
    if isinstance(tree, dict):
        return {k: _cast_like(template[k], v) for k, v in tree.items()}
    return tree.to(template.dtype)


def rotate_checkpoints(model_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` ``model_<N>`` files (0 = keep
    all)."""
    if keep <= 0 or not os.path.isdir(model_dir):
        return
    entries = []
    for name in os.listdir(model_dir):
        m = re.fullmatch(r"model_(\d+)", name)
        if m:
            entries.append((int(m.group(1)), name))
    for _, name in sorted(entries)[:-keep]:
        os.unlink(os.path.join(model_dir, name))
