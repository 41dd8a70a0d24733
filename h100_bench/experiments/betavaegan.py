"""The program's beta-VAE-GAN (``VAEGANExperiment``), as the trainer's
``_run_vaegan`` builds and steps it."""

from __future__ import annotations

from typing import Dict

from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment

from reference import betavaegan as ref

from . import celeba_states as cs

EXPERIMENT = VAEGANExperiment
# what train_epoch sums over an epoch's steps (train/loop.py _run_vaegan)
EPOCH_SUMS = ("recon_enc", "recon_dec", "dis", "D_x")


def load(exp, w, c: Dict) -> None:
    """The benchmark's weights and fresh Adam states into ``exp``."""
    layers = ref.layers(c)
    vae = cs.network_state(w, layers, "vae")
    if c["freeze_mode"] == "intent":
        vae["opt_state"] = {
            part: cs.fresh_adam(cs.trees(w, layers, prefix)[0])
            for part, prefix in (("dec", "vae.decoder"),
                                 ("enc", "vae.encoder"))}
    exp.load_states({"eg": vae,
                     "d": cs.network_state(w, layers, "discriminator")})


def metrics(m: Dict) -> Dict:
    """The step's metrics under the reference's names."""
    return {"recon": m["recon_enc"], "kld": m["kld"], "sim": m["sim"],
            "D_x": m["D_x"]}


def state(exp) -> Dict:
    s = cs.named({"vae": exp.vae, "discriminator": exp.discriminator})
    opts = [exp.opt_d] + (list(exp.opt_eg.values())
                          if isinstance(exp.opt_eg, dict) else [exp.opt_eg])
    s["moments"] = cs.moments(opts, s["ids"])
    return s
