"""Loss functions of the port, float32 math whatever the compute dtype
(disentangle_mlp_tpu/ops/losses.py):

- ``bce``: torch.nn.BCELoss on probabilities (mean reduction, each log term
  clamped at −100) with a finite gradient at p ∈ {0, 1};
- ``bce_logits``: the same objective on raw logits, with bounded gradients;
  the training step uses it;
- ``kld``: unweighted −½·Σ(1 + logσ² − μ² − σ²) over batch and latent dim;
- ``sim_loss``: 0.5·Σ(f_recon − f_real)² over Dis_l features;
- ``reconstruction_loss``: sum-reduction pixel MSE;
- ``vae_loss``: the plain VAE's objective, pixel MSE_sum + KLD.

Under data parallelism over ``world`` ranks each rank computes its share of
the global loss, and the shares sum to it: a sum term is the rank's local
sum; a mean term (``bce``, ``bce_logits``, given ``world``) is the rank's
local mean divided by ``world``, which is its local sum over the global
count, since every rank holds as many rows.
"""

from __future__ import annotations

import torch

_LOG_CLAMP = -100.0
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _log_clamped(x: torch.Tensor) -> torch.Tensor:
    """max(log x, −100) with a zero (not infinite) gradient below the
    smallest normal float32, where the clamp or a denormal takes over."""
    safe = torch.log(torch.clamp(x, min=_F32_TINY))
    denorm = torch.clamp(torch.log(x.detach()), min=_LOG_CLAMP)
    return torch.where(x < _F32_TINY, denorm, safe)


def _log1m_clamped(p: torch.Tensor) -> torch.Tensor:
    """log(1−p) with the −100 clamp at p = 1: log1p below 0.5, the exact
    float32 1−p above it. Each branch's input stays in its own safe range,
    so the branch not taken cannot put inf into the gradient."""
    small = torch.log1p(-torch.clamp(p, max=0.5))
    large = _log_clamped(1.0 - torch.clamp(p, min=0.5))
    return torch.where(p > 0.5, large, small)


def _targets_like(targets, like: torch.Tensor) -> torch.Tensor:
    """``targets`` broadcast to ``like``'s shape. The training steps pass
    0-d float32 tensors on ``like``'s device (train.common.label_tensor),
    which go through without a copy; a Python float becomes a tensor here,
    which on CUDA is a host-to-device copy (refused inside a CUDA graph's
    capture)."""
    return torch.as_tensor(targets, dtype=torch.float32,
                           device=like.device).expand(like.shape)


def share(mean: torch.Tensor, world: int) -> torch.Tensor:
    """One rank's share of a mean over the global batch of ``world`` ranks
    of equal size: its local mean / ``world`` (the mean itself for one)."""
    return mean if world == 1 else mean / world


def bce(probs: torch.Tensor, targets, world: int = 1) -> torch.Tensor:
    """Binary cross entropy on probabilities, mean reduction."""
    probs = probs.float()
    t = _targets_like(targets, probs)
    return share(-torch.mean(t * _log_clamped(probs)
                             + (1.0 - t) * _log1m_clamped(probs)), world)


def bce_logits(logits: torch.Tensor, targets, world: int = 1
               ) -> torch.Tensor:
    """Binary cross entropy on logits, mean reduction:
    max(l, 0) − l·t + log(1 + e^{−|l|})."""
    logits = logits.float()
    t = _targets_like(targets, logits)
    return share(torch.mean(torch.clamp(logits, min=0.0) - logits * t
                            + torch.log1p(torch.exp(-torch.abs(logits)))),
                 world)


def kld(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """−½ Σ (1 + logσ² − μ² − σ²), summed over all elements."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar))


def sim_loss(features_recon: torch.Tensor,
             features_real: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ (Dis_l(x̂) − Dis_l(x))²."""
    diff = features_recon.float() - features_real.float()
    return 0.5 * torch.sum(diff.square())


def reconstruction_loss(recon_x: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """Sum-reduction pixel MSE."""
    diff = recon_x.float() - x.float()
    return torch.sum(diff.square())


def vae_loss(recon_x: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor) -> torch.Tensor:
    """Plain-VAE objective: MSE_sum + KLD."""
    return reconstruction_loss(recon_x, x) + kld(mu, logvar)
