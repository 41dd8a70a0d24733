"""Plain-VAE experiment of the port: one Adam step on MSE_sum + KLD per
batch (disentangle_mlp_tpu/train/vae.py; reference experiments/new_vae.py).

The reparameterization ε comes from the experiment's noise generator
unless the caller passes it (``draws``), which the parity tests do. Under a
mesh each rank steps on its rows of the global batch, as
train/vaegan.py describes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..models.layers import set_mesh
from ..models.vae import VAE
from ..ops.losses import vae_loss
from ..utils.params import adam_from_jax, adam_to_jax
from .common import (DTYPES, Adam, grads, load_model_state, model_state,
                     rank_rows, reduce_grads, reduce_metrics, sampling)


class VAESampling:
    """``decode`` and ``reconstruct`` of an experiment holding a VAE
    (``self.vae``) on ``self.device`` with a noise generator
    (``self.noise_gen``): the VAE and the β-VAE-GAN experiments."""

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Sample images (NHWC, compute dtype) from latents ``z`` with
        train-mode BatchNorm, the running statistics left as they were
        (common.sampling)."""
        with sampling(self.vae.decoder):
            return self.vae.decode(torch.as_tensor(
                z, dtype=torch.float32, device=self.device), train=True)

    def reconstruct(self, x: torch.Tensor,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode, reparameterize (``eps``, or draws from the noise
        generator) and decode ``x``, sampled as :meth:`decode` is."""
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=torch.float32,
                                  device=self.device)
        with sampling(self.vae):
            recon, _, _ = self.vae(x, train=True, eps=eps,
                                   generator=self.noise_gen)
        return recon


class VAEExperiment(VAESampling):
    """The VAE, its Adam and the per-batch ``train_step``; the module is
    updated in place."""

    def __init__(self, cfg: Config, device: torch.device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        self.vae = VAE(
            n_hidden=cfg.n_hidden, n_z=tuple(cfg.n_z),
            representation_size=cfg.representation_size,
            head_width=cfg.head_width,
            decoder_channels=tuple(cfg.decoder_channels),
            input_channels=cfg.input_channels, img_size=cfg.img_size,
            dtype=DTYPES[cfg.dtype], bn_groups=cfg.bn_groups, generator=init,
        ).to(self.device)
        self.vae.train()
        set_mesh(self.vae, mesh)
        self.params = list(self.vae.parameters())
        self.opt = Adam(self.params, cfg.lr, DTYPES[cfg.optimizer_dtype])
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)

    def draw(self, batch_size: int) -> Dict:
        """One step's random draws for this rank's ``batch_size`` rows: the
        reparameterization ε."""
        return {"eps": rank_rows(torch.randn(
            (batch_size * self.world, self.cfg.n_hidden),
            generator=self.noise_gen, device=self.device), self.mesh)}

    def train_step(self, batch: torch.Tensor,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One Adam step on an NHWC float32 ``batch``; returns {"loss"}, the
        batch's summed loss, as a 0-d float32 tensor on the device."""
        draws = draws or self.draw(batch.shape[0])
        eps = torch.as_tensor(draws["eps"], dtype=torch.float32,
                              device=self.device)
        recon, mu, logvar = self.vae(batch, eps=eps)
        loss = vae_loss(recon, batch, mu, logvar)
        self.opt.step(reduce_grads(grads(loss, self.params), self.mesh))
        return reduce_metrics({"loss": loss.detach()}, self.mesh)

    def states(self) -> Dict:
        """{"model"} in the JAX package's checkpoint layout."""
        return {"model": model_state(self.vae,
                                     adam_to_jax(self.opt, self.vae))}

    def load_states(self, states: Dict) -> None:
        load_model_state(self.vae, states["model"])
        adam_from_jax(self.opt, self.vae, states["model"]["opt_state"])
