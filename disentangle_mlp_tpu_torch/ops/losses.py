"""Loss functions of the port, float32 math whatever the compute dtype
(disentangle_mlp_tpu/ops/losses.py):

- ``bce``: torch.nn.BCELoss on probabilities (mean reduction, each log term
  clamped at −100) with a finite gradient at p ∈ {0, 1};
- ``bce_logits``: the same objective on raw logits, with bounded gradients;
  the training step uses it;
- ``kld``: unweighted −½·Σ(1 + logσ² − μ² − σ²) over batch and latent dim;
- ``sim_loss``: 0.5·Σ(f_recon − f_real)² over Dis_l features;
- ``reconstruction_loss``: sum-reduction pixel MSE;
- ``vae_loss``: the plain VAE's objective, pixel MSE_sum + KLD;
- NVAE's terms (Vahdat & Kautz 2020): ``normal`` and ``normal_kl`` (its
  ``Normal`` with the soft clamps), ``disc_mix_logistic_nll`` (the
  discretized logistic mixture, PixelCNN++'s form, 8 bits) and its
  ``disc_mix_logistic_mean``, ``spectral_loss`` (the power iteration's
  largest singular values of the kernels) and ``batchnorm_loss``.

Under data parallelism over ``world`` ranks each rank computes its share of
the global loss, and the shares sum to it: a sum term is the rank's local
sum; a mean term (``bce``, ``bce_logits``, given ``world``) is the rank's
local mean divided by ``world``, which is its local sum over the global
count, since every rank holds as many rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


# -- NVAE ------------------------------------------------------------------

def soft_clamp5(x: torch.Tensor) -> torch.Tensor:
    """5·tanh(x / 5), a differentiable clamp to [-5, 5]."""
    return torch.tanh(x / 5.0) * 5.0


def normal(mu: torch.Tensor, log_sigma: torch.Tensor):
    """(μ, σ) of NVAE's ``Normal(mu, log_sigma)``: both clamped softly,
    σ = exp(log σ) + 0.01."""
    return soft_clamp5(mu), torch.exp(soft_clamp5(log_sigma)) + 1e-2


def normal_kl(mu_q: torch.Tensor, sigma_q: torch.Tensor,
              mu_p: torch.Tensor, sigma_p: torch.Tensor) -> torch.Tensor:
    """KL(q ‖ p) of two diagonal Gaussians, per element, as NVAE computes
    it: ½(((μq − μp)/σp)² + (σq/σp)²) − ½ − log(σq/σp)."""
    t1 = (mu_q - mu_p) / sigma_p
    t2 = sigma_q / sigma_p
    return 0.5 * (t1 * t1 + t2 * t2) - 0.5 - torch.log(t2)


def _mixture(logits: torch.Tensor, num_mix: int):
    """(logit_probs (..., M), means, log_scales, coeffs (..., 3, M)) of an
    image head's (B, H, W, 10·M) output, NVAE's channel order: M mixture
    logits, then for each colour M means, M log-scales, M coefficients."""
    m = num_mix
    l = logits[..., m:].reshape(*logits.shape[:-1], 3, 3 * m)
    return (logits[..., :m], l[..., :m],
            torch.clamp(l[..., m:2 * m], min=-7.0), torch.tanh(l[..., 2 * m:]))


def disc_mix_logistic_nll(logits: torch.Tensor, x: torch.Tensor,
                          num_mix: int, num_bits: int = 8) -> torch.Tensor:
    """−log p(x) of each image, (B,) float32: x (B, H, W, 3) in [-1, 1]
    (levels k / 255 mapped to 2x − 1), ``logits`` the (B, H, W, 10·M)
    image head. Each component is a logistic per colour, the green and
    blue means shifted by the coefficients times the colours before them;
    a level's probability is its bin of width 2/255, the two end levels
    take the tails (x < −0.999, x > 0.999, PixelCNN++'s bounds), and a bin
    whose probability is under 1e-5 takes the density's value instead."""
    logits, x = logits.float(), x.float()
    logit_probs, means, log_scales, coeffs = _mixture(logits, num_mix)
    xs = x.unsqueeze(-1)                                    # (B, H, W, 3, 1)
    m1 = means[..., 1, :] + coeffs[..., 0, :] * xs[..., 0, :]
    m2 = (means[..., 2, :] + coeffs[..., 1, :] * xs[..., 0, :]
          + coeffs[..., 2, :] * xs[..., 1, :])
    centered = xs - torch.stack([means[..., 0, :], m1, m2], dim=-2)
    inv_stdv = torch.exp(-log_scales)
    half = 1.0 / (2.0 ** num_bits - 1)
    plus_in = inv_stdv * (centered + half)
    min_in = inv_stdv * (centered - half)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    mid = torch.where(cdf_delta > 1e-5,
                      torch.log(torch.clamp(cdf_delta, min=1e-10)),
                      log_pdf_mid - math.log((2.0 ** num_bits - 1) / 2))
    log_probs = torch.where(xs < -0.999, log_cdf_plus,
                            torch.where(xs > 0.999, log_one_minus_cdf_min,
                                        mid))
    log_probs = log_probs.sum(-2) + F.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1).sum((1, 2))


def disc_mix_logistic_mean(logits: torch.Tensor, num_mix: int
                           ) -> torch.Tensor:
    """The mixture's mean image (B, H, W, 3) in [-1, 1] (NVAE's
    ``DiscMixLogistic.mean``): means and coefficients weighted by the
    components' probabilities, each colour conditioned on the ones before
    it."""
    logit_probs, means, _, coeffs = _mixture(logits.float(), num_mix)
    sel = torch.softmax(logit_probs, dim=-1).unsqueeze(-2)
    mu = (means * sel).sum(-1)
    c = (coeffs * sel).sum(-1)
    x0 = mu[..., 0]
    x1 = mu[..., 1] + c[..., 0] * x0
    x2 = mu[..., 2] + c[..., 1] * x0 + c[..., 2] * x1
    return torch.clamp(torch.stack([x0, x1, x2], dim=-1), -1.0, 1.0)


def power_iteration(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    steps: int) -> None:
    """``steps`` rounds of NVAE's batched power iteration on the kernel
    matrices w (n, rows, cols), updating the left and right singular
    vectors u (n, rows) and v (n, cols) in place: v ← normalize(uᵀW), then
    u ← normalize(Wv), each with eps 1e-3."""
    with torch.no_grad():
        for _ in range(steps):
            v.copy_(F.normalize(torch.matmul(u.unsqueeze(1), w).squeeze(1),
                                dim=1, eps=1e-3))
            u.copy_(F.normalize(torch.matmul(w, v.unsqueeze(2)).squeeze(2),
                                dim=1, eps=1e-3))


def spectral_loss(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """Σ uᵀWv over a group of kernel matrices: their largest singular
    values as the power iteration estimates them, differentiable in W."""
    return torch.matmul(u.unsqueeze(1),
                        torch.matmul(w, v.unsqueeze(2))).sum()


def batchnorm_loss(scales) -> torch.Tensor:
    """Σ max|γ| over the BatchNorms' scales, one multi-tensor pass."""
    return torch.stack(torch._foreach_norm(list(scales), math.inf)).sum()
