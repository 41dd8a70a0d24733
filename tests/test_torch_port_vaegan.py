"""The port's β-VAE-GAN train_step (disentangle_mlp_tpu_torch/train/vaegan.py)
against the JAX package's step_fn: both start from one init (the JAX
experiment's parameters bridged into the port), consume the same batch and
the same random draws (the labels recomputed from the step's key, the noise
and both ε captured from the JAX step and injected into the port), and run
3 steps in float32 on the CPU; per-phase metrics and the full parameter and
running-stat trees must agree.

Tolerances are those of tests/test_torch_trajectory.py, which explains
them: Adam's g/(|g|+eps) turns float-level gradient differences near g = 0
into ±lr updates (most in 'observed', where every phase updates
everything), and biases that feed a BatchNorm have zero true gradient, so
they random-walk on rounding noise in both frameworks. Normalizing with
2-image BatchNorm groups (bn_groups 2) amplifies that noise step by step,
so that case takes the per-step tolerances of
test_vaegan_trajectory_matches_torch_bn_groups2 there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.config import Config as JaxConfig
from disentangle_mlp_tpu.train.vaegan import create_vaegan_experiment
from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment
from disentangle_mlp_tpu_torch.utils.params import (from_jax, to_jax,
                                                    to_numpy_tree)
from tests.test_torch_compat import (DEC_CH, DISC_CH, FEAT_DIM, HEAD, IMG,
                                     N_HIDDEN, N_Z, RS)
from tests.test_torch_trajectory import (BATCH, BETA, LR, STATS_ATOL, STEPS,
                                         TOL, _assert_tree_close,
                                         _capture_normals, _labels_for)

# bn_groups 2 (tests/test_torch_trajectory.py, bn_groups2 test): metric
# rtol per step, params and running-stat atol
BN2_STEP_RTOL = (1e-2, 5e-2, 2e-1)
BN2_TOL = {"param_atol": 3e-2, "stats_atol": 0.5}


def _cfg_kwargs(mode, bn_groups=1):
    return dict(name=f"port_traj_{mode}", n_hidden=N_HIDDEN, n_z=list(N_Z),
                representation_size=RS, head_width=HEAD,
                decoder_channels=list(DEC_CH), disc_channels=list(DISC_CH),
                disc_feature_dim=FEAT_DIM, img_size=IMG,
                batch_size_train=BATCH, dtype="float32", lr=LR, beta=BETA,
                freeze_mode=mode, bn_groups=bn_groups)


@pytest.mark.parametrize("mode, bn_groups", [("observed", 1), ("intent", 1),
                                             ("observed", 2)])
def test_port_vaegan_step_trajectory_matches_jax(mode, bn_groups):
    """bn_groups 2 is the DataParallel BatchNorm emulation (2-image groups
    at this batch of 4), through every phase of the step."""
    kw = _cfg_kwargs(mode, bn_groups)
    jexp = create_vaegan_experiment(JaxConfig(**kw), jax.random.key(0))
    eg, d = jexp.eg_state, jexp.d_state
    port = VAEGANExperiment(Config(**kw), "cpu")
    from_jax(port.vae, to_numpy_tree(eg.params),
             to_numpy_tree(eg.batch_stats))
    from_jax(port.discriminator, to_numpy_tree(d.params),
             to_numpy_tree(d.batch_stats))

    x_np = np.random.default_rng(0).uniform(
        -1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    x_j, x_t = jnp.asarray(x_np), torch.from_numpy(x_np)
    tol = TOL[mode]
    if bn_groups == 1:
        step_rtol = (tol["metric_rtol"],) * STEPS
        param_atol, stats_atol = tol["param_atol"], STATS_ATOL
    else:
        step_rtol = BN2_STEP_RTOL
        param_atol, stats_atol = BN2_TOL["param_atol"], BN2_TOL["stats_atol"]
    for step in range(STEPS):
        rng = jax.random.fold_in(jax.random.key(7), step)
        real_l, fake_l = _labels_for(rng, 4)
        (eg, d, m), draws = _capture_normals(jexp.step_fn, eg, d, x_j, rng)
        noise, eps_dec, eps_enc = (np.array(a) for a in draws)
        ours = port.train_step(x_t, draws={
            "labels": {"real": real_l, "fake": fake_l}, "noise": noise,
            "eps_dec": eps_dec, "eps_enc": eps_enc})
        for key in ("D_x", "sim", "kld", "recon_enc", "recon_dec", "dis"):
            np.testing.assert_allclose(
                ours[key].item(), float(m[key]), rtol=step_rtol[step],
                err_msg=f"step {step} metric {key}")
        # phase 1 runs before this step's updates: D(x) stays tight
        np.testing.assert_allclose(ours["D_x"].item(), float(m["D_x"]),
                                   rtol=step_rtol[max(0, step - 1)] / 10,
                                   err_msg=f"step {step} phase-1 D_x")

    for what, module, state in (("EG", port.vae, eg), ("D", port.discriminator,
                                                       d)):
        params, stats = to_jax(module)
        _assert_tree_close(state.params, params, param_atol,
                           f"[{mode}] {what} params")
        _assert_tree_close(state.batch_stats, stats, stats_atol,
                           f"[{mode}] {what} running stats")


def test_port_vaegan_intent_freezes_the_other_side():
    """In 'intent' mode the dec and enc Adam states advance once per step
    each, both sides change, and every parameter the step froze requires
    grad again afterwards."""
    port = VAEGANExperiment(Config(**_cfg_kwargs("intent")), "cpu")
    before = {n: p.detach().clone() for n, p in port.vae.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32))
    m = port.train_step(x)
    assert all(np.isfinite(v.item()) for v in m.values())
    assert port.opt_eg["dec"].count == 1 and port.opt_eg["enc"].count == 1
    assert port.opt_d.count == 1
    assert all(p.requires_grad for p in port.vae.parameters())
    assert all(p.requires_grad for p in port.discriminator.parameters())
    changed = {n for n, p in port.vae.named_parameters()
               if not torch.equal(p, before[n])}
    assert any(n.startswith("encoder.") for n in changed)
    assert any(n.startswith("decoder.") for n in changed)
