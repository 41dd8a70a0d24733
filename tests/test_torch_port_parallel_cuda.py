"""Card twins of tests/test_torch_port_parallel.py's (a) and (f): two ranks
sharing the card (gloo: NCCL refuses two ranks on one device), float32,
TF32 off, at the toy widths of tests/test_torch_compat.py and a global
batch of 8, against the port's one-process run on the CPU on the whole
batch (which tests/test_torch_port_parallel.py and
tests/test_torch_port_vaegan.py hold against the JAX package). This file
imports no JAX, so it runs on the GPU machine, which has no flax:

    python -m pytest tests/test_torch_port_parallel_cuda.py -m cuda -q

Tolerances: tests/test_torch_port_card_training.py's float32 card against
CPU ones for the steps; the Inception's card against CPU parity
(rtol 2e-3, atol 2e-4, chip_smoke.py TOL_POOL3) for the activations. The
tests skip without a GPU."""

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.eval import fid as port_fid
from disentangle_mlp_tpu_torch.eval.inception import init_random_params
from disentangle_mlp_tpu_torch.parallel import make_mesh, spawn
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.params import (inception_from_jax,
                                                    to_jax)
# top-level names, as pytest puts tests/ on the path: the GPU machine has
# another package named ``tests`` installed
from test_torch_port_card_training import (BN_CANCELLED, CANCELLED_ATOL,
                                           METRIC_RTOL, PARAM_ATOL,
                                           STATS_ATOL, TOY)
from torch_parallel_worker import run_cases

RANKS, BATCH, STEPS = 2, 8, 2
POOL3_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def _copy(tree):
    """A to_jax tree detached from the module (its arrays share the CPU
    tensors' memory)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _spawn_card(cases):
    outs = spawn(run_cases, make_mesh(devices=["cuda:0"] * RANKS), cases)
    return {c["name"]: [o[c["name"]] for o in outs] for c in cases}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["observed", "intent"])
def test_port_two_ranks_on_the_card_vaegan_step_matches_one_process(card,
                                                                    mode):
    cfg = dict(TOY, name=f"card_ddp_{mode}", batch_size_train=BATCH,
               dtype="float32", lr=1e-3, beta=25.0, freeze_mode=mode)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
    draws = [{"labels": {"real": 0.9, "fake": 0.1},
              **{k: rng.normal(size=(BATCH, 16)).astype(np.float32)
                 for k in ("noise", "eps_dec", "eps_enc")}}
             for _ in range(STEPS)]
    exp = VAEGANExperiment(Config(**cfg), "cpu")
    init = {key: tuple(_copy(t) for t in to_jax(net))
            for key, net in (("eg", exp.vae), ("d", exp.discriminator))}
    want = [{k: float(v) for k, v in exp.train_step(
        torch.from_numpy(x), draws=d).items()} for d in draws]
    got = _spawn_card([{"name": mode, "run": "step", "kind": "vaegan",
                        "config": cfg, "device": "cuda", "init": init,
                        "batch": x, "draws": draws}])[mode]
    for r in got:
        for step, (a, b) in enumerate(zip(r["metrics"], want)):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=METRIC_RTOL,
                                           err_msg=f"step {step} {k}")
        for key, net in (("eg", exp.vae), ("d", exp.discriminator)):
            for part, ours, theirs in zip(("params", "stats"),
                                          r["trees"][key], to_jax(net)):
                for (path, a), (_, b) in zip(_flat(ours), _flat(theirs)):
                    module = path.split("/")[-2]
                    atol = (STATS_ATOL if part == "stats" else
                            CANCELLED_ATOL if path.endswith("bias")
                            and module in BN_CANCELLED else PARAM_ATOL)
                    np.testing.assert_allclose(a, b, rtol=1e-3, atol=atol,
                                               err_msg=f"{key} {path}")
    np.testing.assert_array_equal(got[0]["state"], got[1]["state"])


@pytest.mark.cuda
def test_port_two_ranks_on_the_card_fid_activations_match_one_process(card):
    """12 images, and 13 raw decodes normalized on the ranks (the last
    rank pads a row): per_image_normalize through the kernel."""
    params = init_random_params(seed=0)
    rng = np.random.default_rng(11)
    cases = [{"name": name, "run": "fid", "device": "cuda",
              "inception": params, "normalize": norm, "batch_size": 8,
              "images": rng.uniform(-1.0 if norm else 0.0, 1.0,
                                    (n, 32, 32, 3)).astype(np.float32)}
             for name, n, norm in (("fid", 12, False),
                                   ("fid_norm", 13, True))]
    got = _spawn_card(cases)
    model = inception_from_jax(params)
    prev = port_fid._inception
    port_fid._inception = lambda device: model
    try:
        for case in cases:
            images = torch.from_numpy(case["images"])
            if case["normalize"]:
                images = port_fid.per_image_normalize(images)
            want = port_fid.get_activations(images, batch_size=8)
            for r in got[case["name"]]:
                np.testing.assert_allclose(r["acts"], want, **POOL3_TOL)
    finally:
        port_fid._inception = prev
