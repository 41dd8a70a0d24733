"""The program's NVAE (``NVAEExperiment``), as the trainer's ``_run_nvae``
builds and steps it. The benchmark's draws enter through the same
:func:`reference.nvae.derive` as the reference's, copied into the
program's tensors in place under its own names (``nvae.<name>``)."""

from __future__ import annotations

from typing import Dict

import torch

from disentangle_mlp_tpu_torch.train.nvae import NVAEExperiment

from reference import nvae as ref

from . import celeba_states as cs

EXPERIMENT = NVAEExperiment
# what the trainer's epoch sums (train/loop.py _run_nvae)
EPOCH_SUMS = ("loss", "recon", "kl")


def load(exp, w, c: Dict) -> None:
    """The benchmark's weights, running statistics and power-iteration
    vectors into ``exp``; its Adamax stays fresh."""
    ref.derive(w, c)
    live = cs.named({ref.P: exp.model})
    mine = {**live["params"], **live["stats"]}
    if set(mine) != set(w):
        raise KeyError(f"the program's tensors and the reference's differ: "
                       f"{sorted(set(mine) ^ set(w))[:8]}")
    with torch.no_grad():
        for k, t in mine.items():
            t.copy_(w[k])


def metrics(m: Dict) -> Dict:
    return {k: m[k] for k in ref.METRICS}


def state(exp) -> Dict:
    s = cs.named({ref.P: exp.model})
    s["moments"] = cs.moments([exp.opt], s["ids"])
    return s
