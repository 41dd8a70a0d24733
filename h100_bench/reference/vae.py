"""Plain float32 reference of one VAE training step, the paper's baseline
(the original code's experiments/new_vae.py): x_rec = G(mu + eps *
exp(logvar / 2)), loss = sum (x_rec - x)^2 + KLD(mu, logvar), one Adam step
on every parameter. The step returns the batch's summed ``loss``."""

from __future__ import annotations

from typing import Dict

import torch

from . import celeba, nets

METRICS = ("loss",)


def layers(c: Dict):
    return (celeba.encoder_layers("vae.encoder", c)
            + celeba.decoder_layers("vae.decoder", c))


def draw(gen: torch.Generator, c: Dict, batch: int, device) -> Dict:
    return {"eps": torch.randn((batch, c["n_hidden"]), generator=gen,
                               device=device)}


class Model:
    def __init__(self, c: Dict, w: nets.Weights):
        self.c, self.w = c, w
        self.keys = (celeba.params(w, "vae.encoder")
                     + celeba.params(w, "vae.decoder"))
        self.opt = nets.Adam([w[k] for k in self.keys], c["lr"])
        self.groups = {"vae": self.keys}

    def moments(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.keys, self.opt.mu))

    def step(self, x: torch.Tensor, d: Dict, q: nets.Precision = nets.EXACT
             ) -> Dict[str, torch.Tensor]:
        w = self.w
        mu, lv = nets.encoder(w, "vae.encoder", x, q)
        z = mu + d["eps"] * torch.exp(0.5 * lv)
        recon = nets.decoder(w, "vae.decoder", z, q, tuple(self.c["n_z"]))
        loss = nets.sum_sq(recon, x) + nets.kld(mu, lv)
        self.opt.step(torch.autograd.grad(loss, [w[k] for k in self.keys]))
        return {"loss": loss.detach()}


def step_flops(c: Dict, costs) -> float:
    """FLOPs of the convolutions and dense layers of one step: a forward
    pass of each network, its weight gradients, and the input gradients
    from the images' loss back to the encoder's first layer."""
    b = c["batch_size_train"]
    return (celeba.passes_flops(celeba.encoder_layers("e", c), b, costs,
                                fwd=1, wgrad=1, dgrad=1, first_dgrad=0)
            + celeba.passes_flops(celeba.decoder_layers("g", c), b, costs,
                                  fwd=1, wgrad=1, dgrad=1, first_dgrad=1))


def fused_linear_launches(c: Dict):
    """(M, K, N, x bytes) of the step's dense forward calls: the encoder's
    four and the decoder's first."""
    b = c["batch_size_train"]
    return [(b, l["fin"], l["fout"], 2)
            for l in (celeba.encoder_layers("e", c)
                      + celeba.decoder_layers("g", c))
            if l["kind"] == "linear"]
