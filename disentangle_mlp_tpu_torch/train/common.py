"""Optimizer and label sampling of the port
(disentangle_mlp_tpu/train/common.py).

:class:`Adam` is optax.adam with torch.optim.Adam's defaults (β1 0.9,
β2 0.999, eps 1e-8), applied to an explicit list of parameters: every
parameter of the list takes a step each call (a missing gradient counts as
zero), and the bias corrections use one shared step count, as optax does.
``moment_dtype=torch.bfloat16`` is the opt-in compact mode: moments are
stored in bf16 and all arithmetic is float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 moment_dtype: torch.dtype = torch.float32,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.moment_dtype = moment_dtype
        self.count = 0
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
        self.count += 1
        # bias corrections in float32, as optax computes them
        n = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n)
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

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu,
                                list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)


def sample_labels(generator: torch.Generator) -> Dict[str, float]:
    """Stochastic label smoothing/flipping, one draw per batch:
    real ∈ {0.1, 0.9} w.p. {0.05, 0.95}, fake mirrored
    (reference: new_betavaegan.py:89-90)."""
    u_real, u_fake = torch.rand(2, generator=generator).tolist()
    return {"real": 0.1 if u_real < 0.05 else 0.9,
            "fake": 0.1 if u_fake < 0.95 else 0.9}
