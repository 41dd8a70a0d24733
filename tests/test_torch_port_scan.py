"""The port's K-step function (disentangle_mlp_tpu_torch/train/scan.py
``make_multi_step``) against the JAX package's (disentangle_mlp_tpu/train/
scan.py: ``lax.scan`` of the step under one ``jax.jit``), K = 3, float32, on
the CPU at the toy widths of tests/test_torch_compat.py: the β-VAE-GAN in
both freeze modes (two states), the plain VAE (one state) and the DCGAN
(two states).

Both start from one init (the JAX experiment's parameters bridged into the
port) and take the same three batches. The JAX scan draws step i's
randomness from ``fold_in(rng, i)``; those draws are recovered as the
trajectory tests recover them (tests/test_torch_trajectory.py: the labels
recomputed from the key, the normals captured from the un-jitted step at
that key) and injected into the port. The stacked (K,) metrics and the
final parameter and running-statistic trees must agree within the
tolerances of tests/test_torch_port_vaegan.py (TOL of tests/
test_torch_trajectory.py, which explains them: Adam turns float-level
gradient differences near g = 0 into ±lr updates, 'observed' updates every
parameter in every phase), and each Adam count must be K times its steps
a training step. On the CPU the port's function runs the K steps eagerly;
its CUDA graph is held against the eager steps on the card
(tests/test_torch_port_card_training.py, ``chip_smoke.py`` ``[scan]``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.train.gan import create_gan_experiment
from disentangle_mlp_tpu.train.scan import make_multi_step as jax_multi_step
from disentangle_mlp_tpu.train.vae import create_vae_experiment
from disentangle_mlp_tpu.train.vaegan import create_vaegan_experiment
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.train.scan import make_multi_step
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.params import (from_jax, to_jax,
                                                    to_numpy_tree)
from tests.test_torch_port_vae import toy_kwargs
from tests.test_torch_trajectory import (BATCH, BETA, IMG, STATS_ATOL, TOL,
                                         _assert_tree_close,
                                         _capture_normals, _labels_for)

K = 3

# model, freeze mode → (JAX factory, JAX state names, port experiment,
# {port module attribute: JAX state}, key splits of the step's rng (0: no
# labels), names of the injected normals in draw order, the port's
# optimizers with their Adam steps a training step: the 'observed' VAE
# takes two, phase 2's and phase 3's)
CASES = {
    ("betavaegan", "observed"): (
        create_vaegan_experiment, ("eg_state", "d_state"), VAEGANExperiment,
        {"vae": 0, "discriminator": 1}, 4, ("noise", "eps_dec", "eps_enc"),
        lambda p: [(p.opt_eg, 2), (p.opt_d, 1)]),
    ("betavaegan", "intent"): (
        create_vaegan_experiment, ("eg_state", "d_state"), VAEGANExperiment,
        {"vae": 0, "discriminator": 1}, 4, ("noise", "eps_dec", "eps_enc"),
        lambda p: [(p.opt_eg["dec"], 1), (p.opt_eg["enc"], 1),
                   (p.opt_d, 1)]),
    ("vae", "observed"): (
        create_vae_experiment, ("state",), VAEExperiment, {"vae": 0}, 0,
        ("eps",), lambda p: [(p.opt, 1)]),
    ("gan", "observed"): (
        create_gan_experiment, ("g_state", "d_state"), GANExperiment,
        {"generator": 0, "discriminator": 1}, 2, ("noise",),
        lambda p: [(p.opt_g, 1), (p.opt_d, 1)]),
}


@pytest.mark.parametrize("model, mode", list(CASES))
def test_port_multi_step_matches_jax_make_multi_step(model, mode):
    make, names, port_cls, modules, splits, normals, opts = CASES[model,
                                                                  mode]
    kw = toy_kwargs(f"scan_{model}", freeze_mode=mode, beta=BETA)
    jexp = make(JaxConfig(**kw), jax.random.key(0))
    states = tuple(getattr(jexp, n) for n in names)
    port = port_cls(Config(**kw), "cpu")
    for attr, i in modules.items():
        from_jax(getattr(port, attr), to_numpy_tree(states[i].params),
                 to_numpy_tree(states[i].batch_stats))

    batches = np.random.default_rng(3).uniform(
        -1, 1, (K, BATCH, IMG, IMG, 3)).astype(np.float32)
    rng = jax.random.key(7)
    # the scan's per-step draws: fold_in(rng, i), recovered step by step
    draws, seq = [], states
    for i in range(K):
        key = jax.random.fold_in(rng, i)
        out, captured = _capture_normals(jexp.step_fn, *seq,
                                         jnp.asarray(batches[i]), key)
        seq = out[:-1]
        d = dict(zip(normals, (np.array(a) for a in captured)))
        if splits:
            real, fake = _labels_for(key, splits)
            d["labels"] = {"real": real, "fake": fake}
        draws.append(d)

    *final, metrics = jax_multi_step(jexp.step_fn, n_states=len(names),
                                     donate=False)(*states,
                                                   jnp.asarray(batches), rng)
    ours = make_multi_step(port, K)(torch.from_numpy(batches), draws)

    tol = TOL[mode]
    assert set(ours) == set(metrics)
    for key, want in metrics.items():
        assert tuple(ours[key].shape) == (K,)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(want),
                                   rtol=tol["metric_rtol"],
                                   err_msg=f"{model} {mode} metric {key}")
    for attr, i in modules.items():
        params, stats = to_jax(getattr(port, attr))
        _assert_tree_close(final[i].params, params, tol["param_atol"],
                           f"[{model} {mode}] {attr} params")
        _assert_tree_close(final[i].batch_stats, stats, STATS_ATOL,
                           f"[{model} {mode}] {attr} running stats")
    for opt, per_step in opts(port):
        assert int(opt.count) == K * per_step


def test_port_multi_step_checks_its_inputs():
    """K steps of batches and of draws, or a ValueError naming K."""
    port = VAEExperiment(Config(**toy_kwargs("scan_args")), "cpu")
    multi = make_multi_step(port, 2)
    x = torch.zeros((3, BATCH, IMG, IMG, 3))
    with pytest.raises(ValueError, match="K=2"):
        multi(x)
    with pytest.raises(ValueError, match="K=2"):
        multi(x[:2], [port.draw(BATCH)])
    with pytest.raises(ValueError, match="at least 1"):
        make_multi_step(port, 0)
    with pytest.raises(ValueError, match="CUDA"):
        multi.capture(x[:2])
