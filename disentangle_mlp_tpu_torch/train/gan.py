"""DCGAN experiment of the port: the alternating D/G update
(disentangle_mlp_tpu/train/gan.py; reference experiments/new_gan.py).
Per batch:

(1) Discriminator: loss_D = BCE(D(x), real) + BCE(D(G(z)), fake),
    z ~ N(0, 1); Adam step on D. G runs once, and its graph is kept.
(2) Generator, with the updated D: loss_G = BCE(D(fake), real), where
    ``fake`` is phase 1's G(z), differentiated through its kept graph (the
    reference's retained ``fake``; G has not changed since) under a fresh
    forward of the updated D, whose parameters do not require grad here.
    Adam step on G.

D's BatchNorm running statistics advance in the order real, fake, then
fake again for G; G's come from its one forward. The labels and the noise
come from the experiment's generators unless the caller passes them
(``draws``), which the parity tests do. Under a mesh each rank steps on its
rows of the global batch, as train/vaegan.py describes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..models.gan import DiscriminatorCeleba, GeneratorCeleba
from ..models.layers import set_mesh
from ..ops.losses import bce_logits, share
from ..utils.params import adam_from_jax, adam_to_jax
from .common import (DTYPES, Adam, frozen, grads, label_tensor,
                     load_model_state, model_state, rank_rows, reduce_grads,
                     reduce_metrics, sample_labels, sampling)


class GANExperiment:
    """Generator and discriminator, their optimizers and the per-batch
    ``train_step``; the modules are updated in place."""

    def __init__(self, cfg: Config, device: torch.device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        dtype = DTYPES[cfg.dtype]
        init = torch.Generator().manual_seed(cfg.seed)
        self.generator = GeneratorCeleba(
            n_hidden=cfg.n_hidden, n_z=tuple(cfg.n_z),
            channels=tuple(cfg.decoder_channels),
            output_channels=cfg.input_channels, dtype=dtype,
            bn_groups=cfg.bn_groups, generator=init,
        ).to(self.device)
        self.discriminator = DiscriminatorCeleba(
            input_channels=cfg.input_channels,
            channels=tuple(cfg.disc_channels),
            feature_dim=cfg.disc_feature_dim, img_size=cfg.img_size,
            dtype=dtype, bn_groups=cfg.bn_groups, generator=init,
        ).to(self.device)
        self.generator.train()
        self.discriminator.train()
        set_mesh(self.generator, mesh)
        set_mesh(self.discriminator, mesh)
        moments = DTYPES[cfg.optimizer_dtype]
        self.g_params = list(self.generator.parameters())
        self.d_params = list(self.discriminator.parameters())
        self.opt_g = Adam(self.g_params, cfg.lr, moments)
        self.opt_d = Adam(self.d_params, cfg.lr, moments)
        # host generator for the labels, device generator for the noise
        self.label_gen = torch.Generator().manual_seed(cfg.seed + 1)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)

    def draw(self, batch_size: int) -> Dict:
        """One step's random draws for this rank's ``batch_size`` rows:
        labels and noise."""
        labels = label_tensor(sample_labels(self.label_gen), self.device)
        return {"labels": labels, "noise": rank_rows(torch.randn(
            (batch_size * self.world, self.cfg.n_hidden),
            generator=self.noise_gen, device=self.device), self.mesh)}

    def _d(self, x: torch.Tensor) -> torch.Tensor:
        return self.discriminator(x, train=True, return_logits=True)[0]

    def train_step(self, batch: torch.Tensor,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One D step and one G step on an NHWC float32 ``batch``; returns
        {errD, errG, D_x, D_G_z1, D_G_z2} as 0-d float32 tensors on the
        device."""
        draws = draws or self.draw(batch.shape[0])
        real_l, fake_l = label_tensor(draws["labels"], self.device)
        noise = torch.as_tensor(draws["noise"], dtype=torch.float32,
                                device=self.device)

        # ---------------- (1) Discriminator ---------------------------------
        fake_graph = self.generator(noise, train=True)
        fake = fake_graph.detach()
        l_real = self._d(batch)
        l_fake = self._d(fake)
        w, mesh = self.world, self.mesh
        err_d = bce_logits(l_real, real_l, w) + bce_logits(l_fake, fake_l, w)
        self.opt_d.step(reduce_grads(grads(err_d, self.d_params), mesh))

        # ---------------- (2) Generator, against the updated D -------------
        with frozen(self.d_params):
            l_fake2 = self._d(fake_graph)
            err_g = bce_logits(l_fake2, real_l, w)
            g = reduce_grads(grads(err_g, self.g_params), mesh)
        self.opt_g.step(g)

        def mean_prob(logits):
            return share(torch.sigmoid(logits.detach()).mean(), w)

        return reduce_metrics(
            {"errD": err_d.detach(), "errG": err_g.detach(),
             "D_x": mean_prob(l_real), "D_G_z1": mean_prob(l_fake),
             "D_G_z2": mean_prob(l_fake2)}, mesh)

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Images (NHWC, compute dtype) from latents ``z`` with train-mode
        BatchNorm, the running statistics left as they were
        (common.sampling)."""
        with sampling(self.generator):
            return self.generator(torch.as_tensor(
                z, dtype=torch.float32, device=self.device), train=True)

    def states(self) -> Dict:
        """{"g", "d"} in the JAX package's checkpoint layout."""
        return {"g": model_state(self.generator,
                                 adam_to_jax(self.opt_g, self.generator)),
                "d": model_state(self.discriminator,
                                 adam_to_jax(self.opt_d, self.discriminator))}

    def load_states(self, states: Dict) -> None:
        for net, opt, key in ((self.generator, self.opt_g, "g"),
                              (self.discriminator, self.opt_d, "d")):
            load_model_state(net, states[key])
            adam_from_jax(opt, net, states[key]["opt_state"])
