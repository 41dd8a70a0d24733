"""The program's plain VAE (``VAEExperiment``), as the trainer's
``_run_vae`` builds and steps it."""

from __future__ import annotations

from typing import Dict

from disentangle_mlp_tpu_torch.train.vae import VAEExperiment

from reference import vae as ref

from . import celeba_states as cs

EXPERIMENT = VAEExperiment
EPOCH_SUMS = ("loss",)


def load(exp, w, c: Dict) -> None:
    exp.load_states({"model": cs.network_state(w, ref.layers(c), "vae")})


def metrics(m: Dict) -> Dict:
    return {"loss": m["loss"]}


def state(exp) -> Dict:
    s = cs.named({"vae": exp.vae})
    s["moments"] = cs.moments([exp.opt], s["ids"])
    return s
