"""Optimizer, label sampling and the experiments' shared helpers of the port
(disentangle_mlp_tpu/train/common.py).

:class:`Adamax` is NVAE's optimizer, in the same form.

:class:`Adam` is optax.adam with torch.optim.Adam's defaults (β1 0.9,
β2 0.999, eps 1e-8), applied to an explicit list of parameters: every
parameter of the list takes a step each call (a missing gradient counts as
zero), and the bias corrections use one shared step count, as optax does.
``moment_dtype=torch.bfloat16`` is the opt-in compact mode: moments are
stored in bf16 and all arithmetic is float32. The count is a 0-d int32
tensor on the parameters' device, as optax keeps it, and the bias
corrections are computed from it there: a step reads nothing from the host,
so a CUDA graph of it (train/scan.py) stays right at every replay.

:func:`label_tensor` makes a step's label pair a device tensor, so that the
losses never copy a Python float to the device.

:func:`sampling` is how every experiment decodes, generates and
reconstructs: BatchNorm in train mode, as the JAX package samples, with the
running-statistics update that train mode makes put back afterwards.

Under a mesh (parallel/mesh.py) :func:`reduce_grads` sums each phase's
gradients over the ranks in one all-reduce before ``Adam.step``, and
:func:`reduce_metrics` sums the ranks' shares of a step's metrics, so every
rank returns the global batch's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence, Union

import torch
from torch import nn

from ..models.layers import BatchNorm
from ..parallel.mesh import all_reduce_flat
from ..utils.params import (flax_tree, load_flax_tree, load_stats_tree,
                            stats_tree)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def frozen(params: Iterable[torch.Tensor]):
    """Parameters that do not require grad inside the block."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@contextlib.contextmanager
def sampling(module: nn.Module):
    """No gradients inside the block, and ``module``'s BatchNorm running
    statistics as they were before it. Train-mode BatchNorm normalizes with
    the statistics of the batch it is given (the JAX package's sampling
    mode) and updates its running statistics in place; they are saved and
    put back, so sampling changes nothing a checkpoint saves. Under a mesh
    each rank samples the whole batch it is given, with that batch's own
    statistics (as the JAX package decodes with replicated parameters): the
    BatchNorms leave the mesh inside the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [(m.running_mean.clone(), m.running_var.clone(), m.mesh)
             for m in bns]
    for m in bns:
        m.mesh = None
    try:
        with torch.no_grad():
            yield
    finally:
        for m, (mean, var, mesh) in zip(bns, saved):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
            m.mesh = mesh


def model_state(module: nn.Module, opt_state) -> Dict:
    """One network's checkpoint state in the JAX package's layout
    (utils/checkpoint.py)."""
    return {"params": flax_tree(module), "batch_stats": stats_tree(module),
            "opt_state": opt_state}


def load_model_state(module: nn.Module, state: Dict) -> None:
    """Parameters and running statistics of :func:`model_state`; the
    caller loads ``opt_state`` into its optimizer."""
    load_flax_tree(module, state["params"])
    load_stats_tree(module, state["batch_stats"])


def grads(loss: torch.Tensor, params: List[torch.Tensor]):
    """d loss / d params; None for a parameter the loss does not reach."""
    return torch.autograd.grad(loss, params, allow_unused=True)


def reduce_grads(g: Sequence[Optional[torch.Tensor]], mesh
                 ) -> Sequence[Optional[torch.Tensor]]:
    """The gradients summed over the ranks of ``mesh`` (each rank's loss is
    its share of the global loss, so the sum is the global gradient), in
    one all-reduce of the flattened gradients; as they are without a mesh.
    Which gradients are None is the same on every rank."""
    if mesh is None:
        return g
    live = [i for i, d in enumerate(g) if d is not None]
    sums = all_reduce_flat([g[i] for i in live], mesh)
    out = list(g)
    for i, s in zip(live, sums):
        out[i] = s
    return out


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, torch.Tensor]:
    """A step's metrics of the global batch: each rank's shares (local sums,
    local means over the rank count) summed over the ranks in one
    all-reduce; as they are without a mesh."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    (flat,) = all_reduce_flat([torch.stack([metrics[k] for k in keys])],
                              mesh)
    return {k: flat[i] for i, k in enumerate(keys)}


def rank_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a draw made for the global batch (all of it
    without a mesh): every rank draws the same global normals from its
    identically seeded generator and keeps its own."""
    if mesh is None:
        return t
    per = t.shape[0] // mesh.size
    return t[mesh.rank * per:(mesh.rank + 1) * per]


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 moment_dtype: torch.dtype = torch.float32,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.moment_dtype = moment_dtype
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        self.mu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        g = [torch.zeros_like(p) if d is None else d.float()
             for p, d in zip(self.params, grads)]
        compact = self.moment_dtype != torch.float32
        mu = [m.float() for m in self.mu] if compact else self.mu
        nu = [v.float() for v in self.nu] if compact else self.nu
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        self.count.add_(1)
        # bias corrections in float32 on the device, as optax computes them
        n = self.count.float()
        bc1 = 1.0 - torch.pow(b1, n)
        bc2 = 1.0 - torch.pow(b2, n)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)
        if compact:
            for dst, src in zip(self.mu + self.nu, mu + nu):
                dst.copy_(src)

    def state_tensors(self) -> List[torch.Tensor]:
        """The tensors a step updates in place: moments and count."""
        return self.mu + self.nu + [self.count]


class Adamax:
    """NVAE's Adamax (its ``thirdparty/adamax.py``, the ``--fast_adamax``
    multi-tensor form) with L2 weight decay: g ← g + wd·p; m ← β1·m +
    (1 − β1)·g; u ← max(β2·u, |g| + eps); p ← p − lr/(1 − β1^t)·m/u.
    NVAE's defaults: β (0.9, 0.999), eps 1e-3. ``mu`` holds m (the first
    moment, as :class:`Adam`'s), ``nu`` u; the count is a 0-d int32 device
    tensor and the bias correction is computed from it there, so a CUDA
    graph of a step stays right at every replay."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-3):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        g = [torch.zeros_like(p) if d is None else d.float()
             for p, d in zip(self.params, grads)]
        if self.weight_decay:
            torch._foreach_add_(g, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        bound = torch._foreach_abs(g)
        torch._foreach_add_(bound, self.eps)
        torch._foreach_maximum_(self.nu, bound)
        self.count.add_(1)
        bc = 1.0 - torch.pow(self.b1, self.count.float())
        upd = torch._foreach_div(self.mu, self.nu)
        torch._foreach_div_(upd, bc)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)

    def state_tensors(self) -> List[torch.Tensor]:
        """The tensors a step updates in place: moments and count."""
        return self.mu + self.nu + [self.count]


def sample_labels(generator: torch.Generator) -> Dict[str, float]:
    """Stochastic label smoothing/flipping, one draw per batch:
    real ∈ {0.1, 0.9} w.p. {0.05, 0.95}, fake mirrored
    (reference: new_betavaegan.py:89-90)."""
    u_real, u_fake = torch.rand(2, generator=generator).tolist()
    return {"real": 0.1 if u_real < 0.05 else 0.9,
            "fake": 0.1 if u_fake < 0.95 else 0.9}


def label_tensor(labels: Union[Dict[str, float], torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """A step's (real, fake) labels as a (2,) float32 tensor on ``device``:
    a tensor as it is (moved if it lies elsewhere), a :func:`sample_labels`
    dict through pinned memory by a non-blocking copy on CUDA. The caching
    host allocator keeps each pinned buffer until its copy has run, so the
    host never overwrites a buffer that a queued copy still reads."""
    if isinstance(labels, torch.Tensor):
        return labels.to(device=device, dtype=torch.float32)
    host = torch.tensor([labels["real"], labels["fake"]],
                        dtype=torch.float32)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
