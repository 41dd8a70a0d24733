"""Checkpoint save/restore of the port, in its own torch format.

Same cadence as the JAX package (disentangle_mlp_tpu/utils/checkpoint.py):
one file per saved epoch under ``<save_path>/models/model_<epoch+1>``,
holding {epoch, eg, d}, each state the module's ``state_dict`` and its
optimizer state; ``rotate_checkpoints`` keeps the newest N. Loading the JAX
package's msgpack checkpoints is not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

import torch


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def save_checkpoint(path: str, epoch: int, states: Dict[str, Any]) -> str:
    """Write {epoch, **states} to ``path`` atomically (temp file, rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, **_to_cpu(states)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """The saved dict, tensors on ``device``; tensors and containers only,
    nothing else is unpickled."""
    return torch.load(path, map_location=device, weights_only=True)


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
