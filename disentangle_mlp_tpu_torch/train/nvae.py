"""NVAE experiment of the port (Vahdat & Kautz 2020; models/nvae.py): one
Adamax step a batch on NVAE's training loss,

    loss = mean_b(recon_b + Σ_groups KL_b) + λ·(Σ σ_max + Σ_BN max|γ|),

recon the discretized logistic mixture's −log p(x) of each image, KL each
latent group's analytic KL summed over its latents, σ_max each
convolution's largest singular value as NVAE's power iteration estimates
it (its kernel matrix after weight normalisation, the matrices batched by
shape, 4 iterations a step and 10 times as many in the process's first
step, the singular vectors kept as buffers), λ = ``WEIGHT_DECAY_NORM``
(NVAE's ``--weight_decay_norm``). Adamax (train/common.py) steps every
parameter with L2 weight decay ``WEIGHT_DECAY`` (NVAE's default
``--weight_decay``).

This is NVAE's objective after its warm-ups: KL coefficient 1 and no KL
balancing (NVAE's first 30 % of iterations anneal it), and ``lr`` held (NVAE
warms it up over 5 epochs and decays it by a cosine at epoch ends).

Every group's ε comes from the experiment's noise generator unless the
caller passes it (``draws``): one (B, E) tensor, models/nvae.py
:func:`latent_shapes`. The experiment runs on one device: a mesh is
refused (NVAE's runs synchronise BatchNorm over their 8 GPUs; one card
computes the same statistics over the same global batch).

Spans (utils/runtime.py): ``dmt.nvae.spectral`` around the regulariser,
``dmt.nvae.kl`` around the KL sums; on the host, so they time eager steps.

Checkpoint layout (utils/checkpoint.py): ``{"model": {"params",
"batch_stats", "opt_state"}}``, each tree keyed by the module's own names
(``stem.weight``, ``dec.3.ops.0.bn1.running_mean``, ``sr_u_64x576``, ...),
``opt_state`` ``{"count", "mu", "nu"}`` of the Adamax.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..models.nvae import (MIXTURE, NVAE, Arch, latent_width,
                           spectral_buffer_names, spectral_groups)
from ..ops import losses
from ..utils import runtime
from .common import DTYPES, Adamax, grads, sampling

POWER_ITERATIONS = 4
FIRST_POWER_ITERATIONS = 10 * POWER_ITERATIONS
# NVAE's CelebA 64x64 command: --weight_decay_norm 1e-1, --weight_decay 3e-4
WEIGHT_DECAY_NORM = 0.1
WEIGHT_DECAY = 3e-4


class NVAEExperiment:
    """NVAE, its Adamax and the per-batch ``train_step``; the module and the
    optimizer are updated in place."""

    def __init__(self, cfg: Config, device: torch.device, mesh=None):
        if mesh is not None:
            raise ValueError("the NVAE experiment runs on one device, its "
                             "BatchNorm statistics over the global batch")
        self.cfg, self.mesh = cfg, None
        self.device = torch.device(device)
        self.arch = Arch.from_config(cfg)
        self.width = latent_width(self.arch)
        init = torch.Generator().manual_seed(cfg.seed)
        self.model = NVAE(self.arch, DTYPES[cfg.dtype], init)
        self.groups = spectral_groups(self.model.convs())
        for shape, names in self.groups.items():
            for key, n in zip(spectral_buffer_names(shape), shape):
                self.model.register_buffer(key, torch.nn.functional.normalize(
                    torch.randn((len(names), n), generator=init), dim=1,
                    eps=1e-3))
        self.model.to(self.device).train()
        self.params = list(self.model.parameters())
        self.opt = Adamax(self.params, cfg.lr, WEIGHT_DECAY)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)
        self._convs = dict(self.model.convs())
        self._bn_scales = [m.weight for m in self.model.batchnorms()]
        self.power_iterations = FIRST_POWER_ITERATIONS

    def draw(self, batch_size: int) -> Dict:
        """One step's random draws: every group's ε, (B, E)."""
        return {"eps": torch.randn((batch_size, self.width),
                                   generator=self.noise_gen,
                                   device=self.device)}

    def spectral(self) -> torch.Tensor:
        """Σ of every convolution's largest singular value, after this
        step's power iterations (run on the kernels of the latest
        forward)."""
        steps, self.power_iterations = self.power_iterations, \
            POWER_ITERATIONS
        total = []
        for shape, names in self.groups.items():
            u, v = (getattr(self.model, k)
                    for k in spectral_buffer_names(shape))
            w = torch.stack([self._kernel(n).reshape(shape) for n in names])
            losses.power_iteration(w, u, v, steps)
            total.append(losses.spectral_loss(w, u, v))
        return torch.stack(total).sum()

    def _kernel(self, name: str) -> torch.Tensor:
        m = self._convs[name]
        return m.weight if m.log_weight_norm is None else m.weight_normalized

    def terms(self, batch: torch.Tensor, eps: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """The forward pass and every term of the loss (float32 0-d
        tensors), and ``kl_groups``: each group's KL, the batch's mean."""
        logits, kl = self.model(batch, eps)
        recon = losses.disc_mix_logistic_nll(logits, batch,
                                             MIXTURE)
        kl_groups = torch.stack(kl, dim=1)
        nelbo = (recon + kl_groups.sum(1)).mean()
        with runtime.span("dmt.nvae.spectral"):
            spectral = self.spectral()
        bn = losses.batchnorm_loss(self._bn_scales)
        loss = nelbo + WEIGHT_DECAY_NORM * (spectral + bn)
        return {"loss": loss, "recon": recon.mean(),
                "kl": kl_groups.sum(1).mean(), "spectral": spectral,
                "bn": bn, "kl_groups": kl_groups.mean(0)}

    def train_step(self, batch: torch.Tensor,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One Adamax step on an NHWC float32 ``batch`` in [-1, 1]; returns
        {"loss", "recon", "kl", "spectral", "bn"} as 0-d float32 tensors on
        the device (recon and kl means over the batch)."""
        draws = draws or self.draw(batch.shape[0])
        eps = torch.as_tensor(draws["eps"], dtype=torch.float32,
                              device=self.device)
        terms = self.terms(batch, eps)
        self.opt.step(grads(terms["loss"], self.params))
        return {k: terms[k].detach() for k in
                ("loss", "recon", "kl", "spectral", "bn")}

    # -- sampling -------------------------------------------------------------

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Images (NHWC, float32, [-1, 1]) from the prior for ``z``, every
        group's ε (n, E) (``n_hidden`` is E for this experiment, so the
        trainer's FID latents are such draws), BatchNorm in train mode with
        the running statistics put back (common.sampling)."""
        with sampling(self.model):
            return self.model.sample(torch.as_tensor(
                z, dtype=torch.float32, device=self.device))

    def reconstruct(self, x: torch.Tensor,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x through the posterior's z and the decoder, the mixture's mean
        (NHWC, [-1, 1])."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if eps is None:
            eps = self.draw(x.shape[0])["eps"]
        with sampling(self.model):
            logits, _ = self.model(x, eps)
        return losses.disc_mix_logistic_mean(logits,
                                             MIXTURE)

    # -- checkpoints --------------------------------------------------------

    def states(self) -> Dict:
        """{"model"} in the layout of the module docstring."""
        params = dict(self.model.named_parameters())
        index = {id(p): i for i, p in enumerate(self.opt.params)}
        return {"model": {
            "params": {k: p.detach() for k, p in params.items()},
            "batch_stats": {k: b.detach() for k, b in
                            self.model.named_buffers()},
            "opt_state": {
                "count": self.opt.count.detach(),
                "mu": {k: self.opt.mu[index[id(p)]] for k, p in
                       params.items()},
                "nu": {k: self.opt.nu[index[id(p)]] for k, p in
                       params.items()}}}}

    def load_states(self, states: Dict) -> None:
        """Copy ``states`` (the layout of :meth:`states`) into the live
        tensors, in place: a captured graph holds their addresses."""
        mine = self.states()["model"]
        theirs = states["model"]
        with torch.no_grad():
            for part in ("params", "batch_stats"):
                for k, t in mine[part].items():
                    t.copy_(theirs[part][k])
            for part in ("mu", "nu"):
                for k, t in mine["opt_state"][part].items():
                    t.copy_(theirs["opt_state"][part][k])
            self.opt.count.copy_(torch.as_tensor(
                theirs["opt_state"]["count"]).reshape(()))

