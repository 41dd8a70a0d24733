"""Rank side of tests/test_torch_port_parallel.py: the port's steps,
BatchNorm and FID extraction on one rank of a mesh, from inputs the test
made with the JAX package (numpy only: this module imports no JAX, so the
spawned ranks start fast). :func:`run_cases` runs a list of cases on one
rank and returns what each produced, as numpy."""

from __future__ import annotations

import numpy as np
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.eval import fid as port_fid
from disentangle_mlp_tpu_torch.models import layers
from disentangle_mlp_tpu_torch.parallel.mesh import local_rows
from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.train.scan import state_tensors
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.params import from_jax, to_jax

EXPERIMENTS = {"vaegan": VAEGANExperiment, "vae": VAEExperiment,
               "gan": GANExperiment, "family": FamilyExperiment}
# each experiment's networks: attribute → the JAX state's name
NETWORKS = {"vaegan": {"vae": "eg", "discriminator": "d"},
            "vae": {"vae": "state"},
            "gan": {"generator": "g", "discriminator": "d"},
            "family": {"vae": "eg", "discriminator": "d"}}


def _tree(tree):
    """A to_jax tree as numpy."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor)
                      else tree)


def _rows(a, mesh):
    return a[local_rows(a.shape[0], mesh)]


def step_case(mesh, case) -> dict:
    """One step of an experiment per entry of ``case["draws"]``, from the
    JAX state's parameters, on this rank's rows of the global batch and of
    the draws."""
    kind = case["kind"]
    exp = EXPERIMENTS[kind](Config(**case["config"]), case["device"],
                            mesh=mesh)
    for attr, key in NETWORKS[kind].items():
        params, stats = case["init"][key]
        from_jax(getattr(exp, attr), params, stats)
    x = torch.from_numpy(_rows(case["batch"], mesh)).to(exp.device)
    metrics = []
    for draws in case["draws"]:
        local = {k: v if k == "labels" else _rows(v, mesh)
                 for k, v in draws.items()}
        m = exp.train_step(x, draws=local)
        metrics.append({k: float(v) for k, v in m.items()})
    trees = {key: [_tree(t) for t in to_jax(getattr(exp, attr))]
             for attr, key in NETWORKS[kind].items()}
    state = np.concatenate([t.detach().double().cpu().reshape(-1).numpy()
                            for t in state_tensors(exp)])
    return {"metrics": metrics, "trees": trees, "state": state}


def bn_case(mesh, case) -> dict:
    """A cross-replica BatchNorm (``groups`` over the global batch) in
    train mode on this rank's rows of an NCHW batch: its output, the
    gradient of Σ y·w with respect to its input rows, and its running
    statistics."""
    bn = layers.BatchNorm(case["features"], groups=case["groups"])
    from_jax(bn, *case["init"])
    layers.set_mesh(bn, mesh)
    x = torch.from_numpy(_rows(case["x"], mesh)).requires_grad_()
    y = bn(x, train=True)
    (g,) = torch.autograd.grad(
        (y * torch.from_numpy(_rows(case["w"], mesh))).sum(), x)
    return {"y": y.detach().numpy(), "grad": g.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def fid_case(mesh, case) -> dict:
    """FID activations of all the images, this rank extracting its
    slice."""
    model = port_fid.inception_from_jax(case["inception"]).to(case["device"])
    port_fid._inception = lambda device: model
    images = torch.from_numpy(case["images"]).to(case["device"])
    acts = port_fid.get_activations(images, batch_size=case["batch_size"],
                                    mesh=mesh, normalize=case["normalize"])
    return {"acts": acts}


CASES = {"step": step_case, "bn": bn_case, "fid": fid_case}


def run_cases(mesh, cases: list) -> dict:
    """Every case on this rank: {name: result} (a spawned rank runs under
    the port's float32 policy, TF32 off)."""
    return {c["name"]: CASES[c["run"]](mesh, c) for c in cases}
