"""Plain float32 reference of one beta-VAE-GAN training step (Larsen et al.
2016, with the beta-weighted KL term; the three-phase update of the
original code's experiments/new_betavaegan.py:77-201). Per batch x:

1. Discriminator: L_D = BCE(D(x), real) + BCE(D(G(noise)), fake); an Adam
   step on D. G(noise) keeps its graph for phase 2.
2. Decoder, with the updated D: L_dec = BCE(D(G(noise)), real)
   + BCE(D(x_rec), real) + 0.5 sum (Dis_l(x_rec) - Dis_l(x))^2
   + sum (x_rec - x)^2, with x_rec = G(mu + eps_dec * exp(logvar / 2)) and
   Dis_l(x) a constant; G(noise) is phase 1's decode, differentiated
   through its graph. An Adam step on the VAE.
3. Encoder: L_enc = beta * KLD(mu, logvar) + sum (x_rec - x)^2 with a fresh
   eps_enc; a second Adam step on the VAE.

freeze_mode "observed" steps every VAE parameter in phases 2 and 3 with
one Adam state; "intent" steps only the decoder in phase 2 and only the
encoder in phase 3, each with its own Adam state. The step returns the
encoder phase's pixel loss (``recon``), beta * KLD (``kld``), phase 2's
feature loss (``sim``) and the mean D(x) of phase 1 (``D_x``).

The labels are (real, fake), each 0.9 or 0.1: real is 0.1 with
probability 0.05, fake is 0.9 with probability 0.05 (one draw a batch).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import celeba, nets

METRICS = ("recon", "kld", "sim", "D_x")


def layers(c: Dict):
    return (celeba.encoder_layers("vae.encoder", c)
            + celeba.decoder_layers("vae.decoder", c)
            + celeba.discriminator_layers("discriminator", c))


def draw(gen: torch.Generator, c: Dict, batch: int, device) -> Dict:
    u = torch.rand(2, generator=gen, device=device)
    labels = torch.stack([torch.where(u[0] < 0.05, 0.1, 0.9),
                          torch.where(u[1] < 0.95, 0.1, 0.9)]).float()
    shape = (batch, c["n_hidden"])
    noise, eps_dec, eps_enc = (torch.randn(shape, generator=gen,
                                           device=device) for _ in range(3))
    return {"labels": labels, "noise": noise, "eps_dec": eps_dec,
            "eps_enc": eps_enc}


class Model:
    """The weights, the Adam states and :meth:`step`."""

    def __init__(self, c: Dict, w: nets.Weights):
        self.c, self.w = c, w
        self.intent = c["freeze_mode"] == "intent"
        enc = celeba.params(w, "vae.encoder")
        dec = celeba.params(w, "vae.decoder")
        lr = c["lr"]
        self.groups = {"discriminator": celeba.params(w, "discriminator")}
        if self.intent:
            self.groups.update({"dec": dec, "enc": enc})
        else:
            self.groups["eg"] = enc + dec
        self.opt = {g: nets.Adam([w[k] for k in keys], lr)
                    for g, keys in self.groups.items()}

    def moments(self) -> Dict[str, torch.Tensor]:
        """Each parameter's Adam first moment."""
        return {k: m for g, keys in self.groups.items()
                for k, m in zip(keys, self.opt[g].mu)}

    def _grad(self, loss, group: str):
        keys = self.groups[group]
        return torch.autograd.grad(loss, [self.w[k] for k in keys],
                                   allow_unused=True)

    def step(self, x: torch.Tensor, d: Dict, q: nets.Precision = nets.EXACT
             ) -> Dict[str, torch.Tensor]:
        c, w = self.c, self.w
        real, fake = d["labels"][0], d["labels"][1]
        n_z = tuple(c["n_z"])

        def disc(img):
            return nets.discriminator(w, "discriminator", img, q)

        def vae(img, eps):
            mu, lv = nets.encoder(w, "vae.encoder", img, q)
            z = mu + eps * torch.exp(0.5 * lv)
            return nets.decoder(w, "vae.decoder", z, q, n_z), mu, lv

        # (1) discriminator
        fake_graph = nets.decoder(w, "vae.decoder", d["noise"], q, n_z)
        l_real, _ = disc(x)
        l_fake, _ = disc(fake_graph.detach())
        loss_d = nets.bce_logits(l_real, real) + nets.bce_logits(l_fake, fake)
        self.opt["discriminator"].step(self._grad(loss_d, "discriminator"))
        d_x = torch.sigmoid(l_real.detach()).mean()

        # (2) decoder
        with torch.no_grad():
            _, sim_real = disc(x)
        l_fake2, _ = disc(fake_graph)
        recon, _, _ = vae(x, d["eps_dec"])
        l_recon, sim_recon = disc(recon)
        s_loss = 0.5 * nets.sum_sq(sim_recon, sim_real)
        loss_dec = (nets.bce_logits(l_fake2, real)
                    + nets.bce_logits(l_recon, real) + s_loss
                    + nets.sum_sq(recon, x))
        group = "dec" if self.intent else "eg"
        self.opt[group].step(self._grad(loss_dec, group))
        del fake_graph

        # (3) encoder
        recon, mu, lv = vae(x, d["eps_enc"])
        k_loss = c["beta"] * nets.kld(mu, lv)
        r_loss = nets.sum_sq(recon, x)
        group = "enc" if self.intent else "eg"
        self.opt[group].step(self._grad(k_loss + r_loss, group))
        return {"recon": r_loss.detach(), "kld": k_loss.detach(),
                "sim": s_loss.detach(), "D_x": d_x}


def step_flops(c: Dict, costs) -> float:
    """FLOPs of the convolutions and dense layers of one step: the forward
    passes and the gradients that the three phases need, nothing
    recomputed."""
    b = c["batch_size_train"]
    enc = celeba.encoder_layers("e", c)
    dec = celeba.decoder_layers("g", c)
    dis = celeba.discriminator_layers("d", c)

    def f(net, **kw):
        return celeba.passes_flops(net, b, costs, **kw)

    intent = c["freeze_mode"] == "intent"
    # D: phase 1 real and fake (weights, inputs but the images'), phase 2
    # real (forward only), decode and reconstruction (inputs only, through
    # the first layer to reach the VAE)
    total = f(dis, fwd=2, wgrad=2, dgrad=2, first_dgrad=0)
    total += f(dis, fwd=3, wgrad=0, dgrad=2, first_dgrad=2)
    # G: decode of phase 1 (backward in phase 2, no input gradient into the
    # noise), decodes of phases 2 and 3 (inputs through to the encoder; in
    # "intent" phase 3 takes no decoder weight gradient, phase 2 none of
    # the encoder's, so phase 2 needs no input gradient of the first layer)
    total += f(dec, fwd=1, wgrad=1, dgrad=1, first_dgrad=0)
    total += f(dec, fwd=1, wgrad=1, dgrad=1, first_dgrad=0 if intent else 1)
    total += f(dec, fwd=1, wgrad=0 if intent else 1, dgrad=1, first_dgrad=1)
    # E: phases 2 and 3 (in "intent" phase 2 takes no encoder gradient)
    total += f(enc, fwd=1, wgrad=0 if intent else 1,
               dgrad=0 if intent else 1, first_dgrad=0)
    total += f(enc, fwd=1, wgrad=1, dgrad=1, first_dgrad=0)
    return total


def fused_linear_launches(c: Dict):
    """(M, K, N, x bytes) of each dense layer's forward call in one step,
    the calls the program's bf16 dense kernel makes (backward passes are
    separate matrix products): D's two dense layers in five forward
    passes (its logit layer reads the float32 features), the decoder's
    first in three, the encoder's four in two."""
    b = c["batch_size_train"]
    out = []
    for l in celeba.discriminator_layers("d", c):
        if l["kind"] == "linear":
            xb = 4 if l["name"].endswith("sigmoid_output") else 2
            out += [(b, l["fin"], l["fout"], xb)] * 5
    for l in celeba.decoder_layers("g", c):
        if l["kind"] == "linear":
            out += [(b, l["fin"], l["fout"], 2)] * 3
    for l in celeba.encoder_layers("e", c):
        if l["kind"] == "linear":
            out += [(b, l["fin"], l["fout"], 2)] * 2
    return out
