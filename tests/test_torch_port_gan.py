"""The port's DCGAN experiment (disentangle_mlp_tpu_torch/train/gan.py)
against the JAX package's: one init (the JAX experiment's generator and
discriminator bridged into the port), one batch, the labels recomputed from
the step's key and the noise captured from the JAX step and injected into
the port, 3 float32 steps on the CPU; every metric and the full parameter
and running-stat trees of both networks must agree. Then generate, with
injected latents, against the JAX package's, leaving the running
statistics as they were.

Tolerances are those of tests/test_torch_trajectory.py's GAN test.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.train.gan import create_gan_experiment
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.utils.params import (from_jax, to_jax,
                                                    to_numpy_tree)
from tests.test_torch_compat import N_HIDDEN
from tests.test_torch_port_vae import SAMPLE_TOL, batch, toy_kwargs
from tests.test_torch_trajectory import (STATS_ATOL, STEPS, TOL,
                                         _assert_tree_close, _capture_normals,
                                         _labels_for)

METRICS = ("errD", "errG", "D_x", "D_G_z1", "D_G_z2")


def bridged(seed=0):
    kw = toy_kwargs("port_gan")
    jexp = create_gan_experiment(JaxConfig(**kw), jax.random.key(seed))
    port = GANExperiment(Config(**kw), "cpu")
    for net, state in ((port.generator, jexp.g_state),
                       (port.discriminator, jexp.d_state)):
        from_jax(net, to_numpy_tree(state.params),
                 to_numpy_tree(state.batch_stats))
    return jexp, port


def test_port_gan_step_trajectory_matches_jax():
    jexp, port = bridged()
    g, d = jexp.g_state, jexp.d_state
    x_j, x_t = batch()
    tol = TOL["observed"]
    for step in range(STEPS):
        rng = jax.random.fold_in(jax.random.key(9), step)
        real_l, fake_l = _labels_for(rng, 2)
        (g, d, m), (noise,) = _capture_normals(jexp.step_fn, g, d, x_j, rng)
        ours = port.train_step(x_t, draws={
            "labels": {"real": real_l, "fake": fake_l}, "noise": noise})
        assert set(ours) == set(METRICS)
        for key in METRICS:
            np.testing.assert_allclose(ours[key].item(), float(m[key]),
                                       rtol=tol["metric_rtol"],
                                       err_msg=f"step {step} metric {key}")
    assert port.opt_g.count == port.opt_d.count == STEPS
    for what, net, state in (("G", port.generator, g),
                             ("D", port.discriminator, d)):
        params, stats = to_jax(net)
        _assert_tree_close(state.params, params, tol["param_atol"],
                           f"{what} params")
        # D's statistics moved three times a step: real, fake, fake for G
        _assert_tree_close(state.batch_stats, stats, STATS_ATOL,
                           f"{what} running stats")


def test_port_gan_generate_matches_jax_and_keeps_running_stats():
    jexp, port = bridged(seed=1)
    x_j, x_t = batch()
    rng = jax.random.key(3)
    (g, d, _), (noise,) = _capture_normals(jexp.step_fn, jexp.g_state,
                                           jexp.d_state, x_j, rng)
    real_l, fake_l = _labels_for(rng, 2)
    port.train_step(x_t, draws={"labels": {"real": real_l, "fake": fake_l},
                                "noise": noise})
    from_jax(port.generator, to_numpy_tree(g.params),
             to_numpy_tree(g.batch_stats))
    before = {k: v.clone() for k, v in port.generator.state_dict().items()
              if "running" in k}
    z = np.random.default_rng(4).normal(size=(6, N_HIDDEN)).astype(
        np.float32)
    want = jexp.generate(g, jnp.asarray(z))
    got = port.generate(torch.from_numpy(z))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE_TOL)
    after = port.generator.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)
