"""The port's plain-VAE experiment (disentangle_mlp_tpu_torch/train/vae.py)
against the JAX package's: one init (the JAX experiment's parameters
bridged into the port), one batch and the same ε (captured from the JAX
step and injected into the port), 3 float32 steps on the CPU; the loss, the
full parameter and running-stat trees and the Adam state must agree. Then
decode and reconstruct, with injected latents and ε, against the JAX
package's, leaving the running statistics as they were.

Tolerances are those of tests/test_torch_trajectory.py ('observed': every
step updates every parameter), which explains them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.train.vae import create_vae_experiment
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.utils.params import (adam_to_jax, from_jax,
                                                    to_jax, to_numpy_tree)
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)
from tests.test_torch_trajectory import (BATCH, LR, STATS_ATOL, STEPS, TOL,
                                         _assert_tree_close, _capture_normals)

# decode / reconstruct of one float32 state: forward parity only
# (tests/test_torch_port_models.py MODEL_TOL)
SAMPLE_TOL = dict(rtol=1e-4, atol=1e-4)


def toy_kwargs(name, **kw):
    base = dict(name=name, n_hidden=N_HIDDEN, n_z=list(N_Z),
                representation_size=RS, head_width=HEAD,
                decoder_channels=list(DEC_CH), disc_channels=list(DISC_CH),
                disc_feature_dim=FEAT_DIM, img_size=IMG,
                batch_size_train=BATCH, dtype="float32", lr=LR)
    base.update(kw)
    return base


def batch():
    x = np.random.default_rng(0).uniform(
        -1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def bridged(seed=0):
    """The JAX VAE experiment and a port one holding its parameters."""
    kw = toy_kwargs("port_vae")
    jexp = create_vae_experiment(JaxConfig(**kw), jax.random.key(seed))
    port = VAEExperiment(Config(**kw), "cpu")
    from_jax(port.vae, to_numpy_tree(jexp.state.params),
             to_numpy_tree(jexp.state.batch_stats))
    return jexp, port


def jax_vae_step(jexp, state, x, step):
    """One JAX step (the un-jitted step_fn); returns (state, metrics, ε)."""
    rng = jax.random.fold_in(jax.random.key(11), step)
    (state, m), (eps,) = _capture_normals(jexp.step_fn, state, x, rng)
    return state, m, eps


def test_port_vae_step_trajectory_matches_jax():
    jexp, port = bridged()
    state = jexp.state
    x_j, x_t = batch()
    tol = TOL["observed"]
    for step in range(STEPS):
        state, m, eps = jax_vae_step(jexp, state, x_j, step)
        ours = port.train_step(x_t, draws={"eps": eps})
        assert set(ours) == {"loss"}
        np.testing.assert_allclose(ours["loss"].item(), float(m["loss"]),
                                   rtol=tol["metric_rtol"],
                                   err_msg=f"step {step} loss")
    params, stats = to_jax(port.vae)
    _assert_tree_close(state.params, params, tol["param_atol"],
                       "VAE params")
    _assert_tree_close(state.batch_stats, stats, STATS_ATOL,
                       "VAE running stats")
    opt = adam_to_jax(port.opt, port.vae)["0"]
    adam = state.opt_state[0]
    assert int(opt["count"]) == int(adam.count) == STEPS
    # the moments in the flax layout: same tree, same shapes, close values
    _assert_tree_close(adam.mu, _numpy(opt["mu"]), tol["param_atol"],
                       "Adam mu")


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _running_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k}


@pytest.mark.parametrize("what", ["decode", "reconstruct"])
def test_port_vae_sampling_matches_jax_and_keeps_running_stats(what):
    """Train-mode BatchNorm over the sample batch, as the JAX package
    samples; the port's running statistics are left bit for bit."""
    jexp, port = bridged(seed=1)
    x_j, x_t = batch()
    state, _, eps = jax_vae_step(jexp, jexp.state, x_j, 0)
    port.train_step(x_t, draws={"eps": eps})  # running stats off their init
    from_jax(port.vae, to_numpy_tree(state.params),
             to_numpy_tree(state.batch_stats))
    before = _running_stats(port.vae)
    if what == "decode":
        z = np.random.default_rng(2).normal(size=(6, N_HIDDEN)).astype(
            np.float32)
        want = jexp.decode(state, jnp.asarray(z))
        got = port.decode(torch.from_numpy(z))
    else:
        with jax.disable_jit():  # so the ε draw is concrete and captured
            want, (eps,) = _capture_normals(jexp.reconstruct, state, x_j,
                                            jax.random.key(5))
        got = port.reconstruct(x_t, eps=torch.from_numpy(eps))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLE_TOL)
    after = _running_stats(port.vae)
    assert all(torch.equal(after[k], before[k]) for k in before)
