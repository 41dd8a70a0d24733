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

:class:`AsyncCheckpointer` is the JAX package's: ``save`` snapshots the
state on the device and returns, and a worker thread copies it to the
host, writes the file and only then rotates.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from . import msgpack, runtime

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cast_opt_state(states: Dict[str, Any], opt_state_dtype: Optional[str]
                    ) -> Dict[str, Any]:
    """``states`` with the float32 optimizer leaves cast to
    ``opt_state_dtype`` (where it is bfloat16), on their device."""
    target = _DTYPES[opt_state_dtype or "float32"]
    if target == torch.float32:
        return states

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(target) if t.dtype == torch.float32 else t

    return {name: dict(state, opt_state=_map(state["opt_state"], cast))
            for name, state in states.items()}


def save_checkpoint(path: str, epoch: int, states: Dict[str, Any],
                    opt_state_dtype: Optional[str] = None) -> str:
    """Write {epoch, states} to ``path`` atomically (temp file, rename).
    ``opt_state_dtype='bfloat16'`` stores the float32 optimizer leaves in
    bf16."""
    states = _cast_opt_state(states, opt_state_dtype)
    out = {name: _map(state, lambda t: t.detach().cpu())
           for name, state in states.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack.dump({"epoch": epoch, "states": out}, f)
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Overlapped checkpoint writes, single flight (the JAX package's
    utils/checkpoint.py ``AsyncCheckpointer``).

    ``save`` waits for the previous save, casts the moments on the device
    under ``opt_state_dtype='bfloat16'``, clones every tensor of ``states``
    on its device (the port's steps update the live tensors in place, so
    the file must be written from a copy) and records an event, and
    returns. A worker thread with its own CUDA stream waits on that event,
    copies the snapshot to the host and writes it through
    :func:`save_checkpoint` (temp file, rename); only after the file has
    landed does it keep the newest ``rotate_keep`` files. The file is
    byte-identical to ``save_checkpoint``'s. An error of the worker is
    raised by the next ``save`` or ``wait``. ``last`` holds the latest
    save's path, size, the seconds ``save`` blocked and the seconds from
    its call until the file landed."""

    def __init__(self, opt_state_dtype: Optional[str] = None):
        self._opt_state_dtype = opt_state_dtype
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last: Dict[str, Any] = {}

    def save(self, path: str, epoch: int, states: Dict[str, Any],
             rotate_keep: int = 0) -> None:
        t0 = time.perf_counter()
        with runtime.span("dmt.ckpt.save"):
            self.wait()
            snap = _map(_cast_opt_state(states, self._opt_state_dtype),
                        lambda t: t.detach().clone())
            leaf = next(_leaves(snap), None)
            event = None
            if leaf is not None and leaf.is_cuda:
                event = torch.cuda.Event()
                event.record()
        blocked = time.perf_counter() - t0

        def worker():
            try:
                if event is None:
                    save_checkpoint(path, epoch, snap)
                else:
                    stream = torch.cuda.Stream(leaf.device)
                    with torch.cuda.stream(stream):
                        stream.wait_event(event)
                        save_checkpoint(path, epoch, snap)
                landed = time.perf_counter() - t0
                rotate_checkpoints(os.path.dirname(path), rotate_keep)
                self.last = {"path": path, "bytes": os.path.getsize(path),
                             "blocked_s": blocked, "landed_s": landed}
            except BaseException as e:  # raised by the next save or wait
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="dmt-checkpoint")
        self._thread.start()

    def wait(self) -> None:
        """Until the save in flight has landed; raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
