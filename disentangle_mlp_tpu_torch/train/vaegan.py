"""β-VAE-GAN experiment of the port — the flagship three-phase alternating
update (disentangle_mlp_tpu/train/vaegan.py; reference
experiments/new_betavaegan.py:77-201). Per batch:

(1) Discriminator: loss_D = BCE(D(x), real) + BCE(D(decode(z)), fake),
    z ~ N(0, 1); Adam step on D. The decode keeps its graph.
(2) Decoder, with the updated D:
    loss_dec = BCE(D(fake), real) + BCE(D(x̂), real)
             + 0.5·Σ(Dis_l(x̂) − Dis_l(x))² + Σ(x̂ − x)²,
    where ``fake`` is phase 1's decode, differentiated through its kept
    graph (the reference's retained graph; the VAE has not changed since),
    and Dis_l(x) is a constant. Adam step on the VAE.
(3) Encoder: loss_enc = β·KLD(μ, logσ²) + Σ(x̂ − x)² with fresh ε; second
    Adam step.

The discriminator's BatchNorm running statistics advance in the JAX order:
real, fake in phase 1; real, fake, recon in phase 2.

freeze_mode 'observed' updates every VAE parameter in phases 2 and 3 with
one shared Adam state; 'intent' trains only the decoder in phase 2 and only
the encoder in phase 3, with independent ``dec``/``enc`` Adam states, and
the frozen side's parameters do not require grad, so no weight gradient of
theirs is ever computed. D's parameters likewise do not require grad in
phase 2.

β is a runtime argument. The labels, the noise and each phase's ε come
from the experiment's generators unless the caller passes them
(``draws``), which the parity tests do.

Under a mesh (``mesh``: parallel/mesh.py) each rank steps on its rows of
the global batch: BatchNorm statistics of the global batch, each loss term
this rank's share of the global one (sums local, means over the rank
count), the gradients summed over the ranks before each Adam step, the
draws the global batch's from identically seeded generators, this rank's
rows kept, and the metrics those of the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..models.gan import DiscriminatorCeleba
from ..models.layers import set_mesh
from ..models.vae import VAE
from ..ops.losses import (bce_logits, kld, reconstruction_loss, share,
                          sim_loss)
from ..utils.params import adam_from_jax, adam_to_jax
from .common import (DTYPES, Adam, frozen, grads, label_tensor,
                     load_model_state, model_state, rank_rows, reduce_grads,
                     reduce_metrics, sample_labels)
from .vae import VAESampling


class VAEGANExperiment(VAESampling):
    """The models, their optimizers and the per-batch ``train_step``; the
    modules are updated in place."""

    def __init__(self, cfg: Config, device: torch.device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        dtype = DTYPES[cfg.dtype]
        init = torch.Generator().manual_seed(cfg.seed)
        self.vae = VAE(
            n_hidden=cfg.n_hidden, n_z=tuple(cfg.n_z),
            representation_size=cfg.representation_size,
            head_width=cfg.head_width,
            decoder_channels=tuple(cfg.decoder_channels),
            input_channels=cfg.input_channels, img_size=cfg.img_size,
            dtype=dtype, bn_groups=cfg.bn_groups, generator=init,
        ).to(self.device)
        self.discriminator = DiscriminatorCeleba(
            input_channels=cfg.input_channels,
            channels=tuple(cfg.disc_channels),
            feature_dim=cfg.disc_feature_dim, img_size=cfg.img_size,
            dtype=dtype, bn_groups=cfg.bn_groups, generator=init,
        ).to(self.device)
        self.vae.train()
        self.discriminator.train()
        set_mesh(self.vae, mesh)
        set_mesh(self.discriminator, mesh)
        self.intent = cfg.freeze_mode == "intent"
        self.beta = float(cfg.beta)
        moments = DTYPES[cfg.optimizer_dtype]
        self.enc_params = list(self.vae.encoder.parameters())
        self.dec_params = list(self.vae.decoder.parameters())
        self.d_params = list(self.discriminator.parameters())
        if self.intent:
            self.opt_eg = {"dec": Adam(self.dec_params, cfg.lr, moments),
                           "enc": Adam(self.enc_params, cfg.lr, moments)}
        else:
            self.opt_eg = Adam(self.enc_params + self.dec_params, cfg.lr,
                               moments)
        self.opt_d = Adam(self.d_params, cfg.lr, moments)
        # host generator for the labels, device generator for the normals
        self.label_gen = torch.Generator().manual_seed(cfg.seed + 1)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)

    def draw(self, batch_size: int) -> Dict:
        """One step's random draws for this rank's ``batch_size`` rows:
        labels, noise and the two ε."""
        shape = (batch_size * self.world, self.cfg.n_hidden)

        def normal():
            return rank_rows(torch.randn(shape, generator=self.noise_gen,
                                         device=self.device), self.mesh)

        labels = label_tensor(sample_labels(self.label_gen), self.device)
        return {"labels": labels, "noise": normal(), "eps_dec": normal(),
                "eps_enc": normal()}

    def _d(self, x: torch.Tensor):
        return self.discriminator(x, train=True, return_logits=True)

    def train_step(self, batch: torch.Tensor, beta: Optional[float] = None,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One three-phase update on an NHWC float32 ``batch``; returns the
        metrics as 0-d float32 tensors on the device."""
        beta = self.beta if beta is None else beta
        draws = draws or self.draw(batch.shape[0])
        real_l, fake_l = label_tensor(draws["labels"], self.device)
        noise, eps_dec, eps_enc = (
            torch.as_tensor(draws[k], dtype=torch.float32, device=self.device)
            for k in ("noise", "eps_dec", "eps_enc"))
        eg_params = self.dec_params if self.intent else \
            self.enc_params + self.dec_params

        # ---------------- (1) Discriminator ---------------------------------
        # the decode keeps its graph: phase 2's errG_fake pulls back through
        # it (the reference's retained graph)
        fake_graph = self.vae.decode(noise)
        fake = fake_graph.detach()
        l_real, _ = self._d(batch)
        l_fake, _ = self._d(fake)
        w, mesh = self.world, self.mesh
        loss_d = (bce_logits(l_real, real_l, w)
                  + bce_logits(l_fake, fake_l, w))
        self.opt_d.step(reduce_grads(grads(loss_d, self.d_params), mesh))
        d_x = share(torch.sigmoid(l_real.detach()).mean(), w)

        # ---------------- (2) Decoder ---------------------------------------
        with torch.no_grad():
            _, sim_real = self._d(batch)  # updated D; constant for the VAE
        with frozen(self.d_params), frozen(self.enc_params if self.intent
                                           else []):
            l_fake2, _ = self._d(fake_graph)
            recon, _, _ = self.vae(batch, eps=eps_dec)
            l_recon, sim_recon = self._d(recon)
            s_loss = sim_loss(sim_recon, sim_real)
            loss_dec = (bce_logits(l_fake2, real_l, w)
                        + bce_logits(l_recon, real_l, w)
                        + s_loss + reconstruction_loss(recon, batch))
            g = reduce_grads(grads(loss_dec, eg_params), mesh)
        (self.opt_eg["dec"] if self.intent else self.opt_eg).step(g)
        del fake_graph

        # ---------------- (3) Encoder ---------------------------------------
        enc_train = self.enc_params if self.intent else eg_params
        with frozen(self.dec_params if self.intent else []):
            recon, mu, logvar = self.vae(batch, eps=eps_enc)
            k_loss = beta * kld(mu, logvar)
            r_loss = reconstruction_loss(recon, batch)
            g = reduce_grads(grads(k_loss + r_loss, enc_train), mesh)
        (self.opt_eg["enc"] if self.intent else self.opt_eg).step(g)

        # both "enc" and "dec" running losses accumulate the encoder-phase
        # pixel MSE, and "dis" holds mean D(x) (new_betavaegan.py:107,189-190)
        m = reduce_metrics({"recon": r_loss.detach(), "D_x": d_x,
                            "kld": k_loss.detach(), "sim": s_loss.detach()},
                           mesh)
        return {"recon_enc": m["recon"], "recon_dec": m["recon"],
                "dis": m["D_x"], "D_x": m["D_x"], "kld": m["kld"],
                "sim": m["sim"]}

    def states(self) -> Dict:
        """{"eg", "d"} in the JAX package's checkpoint layout; the
        'intent' VAE state holds split {"dec", "enc"} Adam states."""
        if self.intent:
            eg_opt = {"dec": adam_to_jax(self.opt_eg["dec"], self.vae.decoder),
                      "enc": adam_to_jax(self.opt_eg["enc"], self.vae.encoder)}
        else:
            eg_opt = adam_to_jax(self.opt_eg, self.vae)
        return {"eg": model_state(self.vae, eg_opt),
                "d": model_state(self.discriminator,
                                 adam_to_jax(self.opt_d, self.discriminator))}

    def load_states(self, states: Dict) -> None:
        load_model_state(self.vae, states["eg"])
        load_model_state(self.discriminator, states["d"])
        eg_opt = states["eg"]["opt_state"]
        if self.intent:
            adam_from_jax(self.opt_eg["dec"], self.vae.decoder, eg_opt["dec"])
            adam_from_jax(self.opt_eg["enc"], self.vae.encoder, eg_opt["enc"])
        else:
            adam_from_jax(self.opt_eg, self.vae, eg_opt)
        adam_from_jax(self.opt_d, self.discriminator,
                      states["d"]["opt_state"])
