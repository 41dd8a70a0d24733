"""The birds and MNIST model families' experiment of the port
(disentangle_mlp_tpu/train/families.py; the reference defines these models,
models/model.py:16-183, but never trains them). Per batch, one Adam each
for EG (encoder + generator) and D:

(a) G decodes z_prior ~ N(0, 1) in train mode, outside any graph: its
    BatchNorm running statistics advance (not under ``common.sampling``);
(b) D step: BCE(D(x), real) + BCE(D(fake), fake) on logits; D's running
    statistics advance on x, then on the fake;
(c) EG step against the updated D, whose parameters are frozen:
    β·Σ KLD + Σ(x̂ − x)² + BCE(D(x̂), real), where (z, KLD) = E(x) and
    x̂ = G(z); D runs in train mode on x̂ and its statistics advance again.

Metrics: ``loss`` (the EG loss), ``errD``, ``recon`` (Σ(x̂ − x)²) and
``D_x``. β is ``cfg.beta``, as in the JAX package (whose default 50 is
kept). The labels, z_prior and ε come from the experiment's generators
unless the caller passes them (``draws``), which the parity tests do.

Models: birds, a ResNet-18 encoder at 128×128 (``--resnet18_ckpt``, a
torchvision state dict, is loaded into it when the file exists) with the
birds G and D, latent ``n_hidden``; MNIST, the conv encoder whose latent is
the (img/4, img/4, 4) map flattened in (H, W, C) order, which the
generator reshapes back. :class:`FamilyVAE` holds encoder and generator as
one module, so one Adam state covers both and the checkpoint's ``eg`` tree
is ``{"encoder", "generator"}`` as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..data.pipeline import uses_real_mnist
from ..models.birds import BirdsDiscriminator, BirdsEncoder, BirdsGenerator
from ..models.mnist import (LATENT_CHANNELS, MnistDiscriminator,
                            MnistEncoder, MnistGenerator)
from ..models.resnet import load_torch_checkpoint
from ..ops.losses import bce_logits, reconstruction_loss
from ..utils.params import adam_from_jax, adam_to_jax
from .common import (DTYPES, Adam, frozen, grads, load_model_state,
                     model_state, sample_labels, sampling)

FAMILY_DATASETS = ("birds", "mnist")


class FamilyVAE(nn.Module):
    def __init__(self, encoder: nn.Module, generator: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.generator = generator

    def forward(self, x: torch.Tensor, eps: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NHWC images → (reconstruction NHWC, z, KLD per sample)."""
        z, kld = self.encoder(x, eps, train)
        return self.generator(z, train), z, kld

    def decode(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.generator(z, train)


def build_models(cfg: Config, generator: torch.Generator
                 ) -> Tuple[FamilyVAE, nn.Module, int]:
    """(VAE, discriminator, latent size) of ``cfg.dataset``'s family, with
    the JAX package's refusals."""
    dtype = DTYPES[cfg.dtype]
    g = generator
    if cfg.dataset == "birds":
        if cfg.img_size != 128:
            raise ValueError(
                "the birds G/D ladders are hard-wired to 128x128 "
                "(reference models/model.py:41-100); pass --img_size 128")
        vae = FamilyVAE(BirdsEncoder(cfg.n_hidden, dtype, g,
                                     cfg.input_channels),
                        BirdsGenerator(cfg.n_hidden, dtype, g))
        return vae, BirdsDiscriminator(cfg.input_channels, dtype, g), \
            cfg.n_hidden
    if cfg.dataset == "mnist":
        if cfg.img_size % 4:
            raise ValueError("mnist encoder pools 2x2 twice; "
                             "--img_size must be divisible by 4")
        if cfg.input_channels != 1 and uses_real_mnist(cfg):
            # the idx loader yields 1-channel batches; the synthetic
            # fallback honours --input_channels
            raise ValueError("mnist is single-channel; pass "
                             "--input_channels 1")
        hw = cfg.img_size // 4
        c = cfg.input_channels
        vae = FamilyVAE(MnistEncoder(c, g), MnistGenerator(hw, c, g))
        return vae, MnistDiscriminator(c, cfg.img_size, g), \
            hw * hw * LATENT_CHANNELS
    raise ValueError(f"no model family for dataset {cfg.dataset!r}")


class FamilyExperiment:
    """The family's VAE and D, their optimizers and the per-batch
    ``train_step``; the modules are updated in place."""

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        vae, disc, self.z_dim = build_models(cfg, init)
        if cfg.dataset == "birds" and cfg.resnet18_ckpt:
            load_torch_checkpoint(vae.encoder.resnet, cfg.resnet18_ckpt)
        self.vae = vae.to(self.device).train()
        self.discriminator = disc.to(self.device).train()
        self.beta = float(cfg.beta)
        moments = DTYPES[cfg.optimizer_dtype]
        self.eg_params = list(self.vae.parameters())
        self.d_params = list(self.discriminator.parameters())
        self.opt_eg = Adam(self.eg_params, cfg.lr, moments)
        self.opt_d = Adam(self.d_params, cfg.lr, moments)
        # host generator for the labels, device generator for the normals
        self.label_gen = torch.Generator().manual_seed(cfg.seed + 1)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)

    def draw(self, batch_size: int) -> Dict:
        """One step's random draws: labels, z_prior and ε."""
        def normal():
            return torch.randn((batch_size, self.z_dim),
                               generator=self.noise_gen, device=self.device)

        return {"labels": sample_labels(self.label_gen), "z_prior": normal(),
                "eps": normal()}

    def _d(self, x: torch.Tensor) -> torch.Tensor:
        return self.discriminator(x, train=True, return_logits=True)[0]

    def train_step(self, batch: torch.Tensor,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """(a) the prior decode, (b) the D step, (c) the EG step on an NHWC
        float32 ``batch``; returns {loss, errD, recon, D_x} as 0-d float32
        tensors on the device."""
        draws = draws or self.draw(batch.shape[0])
        real_l = draws["labels"]["real"]
        fake_l = draws["labels"]["fake"]
        z_prior, eps = (torch.as_tensor(draws[k], dtype=torch.float32,
                                        device=self.device)
                        for k in ("z_prior", "eps"))

        # (a) train-mode decode: G's running statistics advance
        with torch.no_grad():
            fake = self.vae.decode(z_prior)

        # (b) discriminator
        l_real = self._d(batch)
        l_fake = self._d(fake)
        err_d = bce_logits(l_real, real_l) + bce_logits(l_fake, fake_l)
        self.opt_d.step(grads(err_d, self.d_params))
        d_x = torch.sigmoid(l_real.detach()).mean()

        # (c) encoder + generator against the updated, frozen D
        with frozen(self.d_params):
            recon, _, kld = self.vae(batch, eps)
            recon_l = reconstruction_loss(recon, batch)
            loss = (self.beta * torch.sum(kld) + recon_l
                    + bce_logits(self._d(recon), real_l))
            g = grads(loss, self.eg_params)
        self.opt_eg.step(g)
        return {"loss": loss.detach(), "errD": err_d.detach(),
                "recon": recon_l.detach(), "D_x": d_x}

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Images (NHWC) from latents ``z`` with train-mode BatchNorm, the
        running statistics left as they were (common.sampling)."""
        with sampling(self.vae):
            return self.vae.decode(torch.as_tensor(
                z, dtype=torch.float32, device=self.device))

    def states(self) -> Dict:
        """{"eg", "d"} in the JAX package's checkpoint layout."""
        return {"eg": model_state(self.vae, adam_to_jax(self.opt_eg,
                                                        self.vae)),
                "d": model_state(self.discriminator,
                                 adam_to_jax(self.opt_d, self.discriminator))}

    def load_states(self, states: Dict) -> None:
        for net, opt, key in ((self.vae, self.opt_eg, "eg"),
                              (self.discriminator, self.opt_d, "d")):
            load_model_state(net, states[key])
            adam_from_jax(opt, net, states[key]["opt_state"])
