"""Training on the card against training on the CPU: the port's toy-width
β-VAE-GAN (3 steps, the configuration of tests/test_torch_port_vaegan.py,
both freeze modes) and its MNIST family step (3 steps at 28×28), in float32
with TF32 off for matmuls and cuDNN, one initialization and the same
injected draws on both devices. These tests need a CUDA GPU and skip
without one; they import neither PIL nor the JAX package:

    python -m pytest tests/test_torch_port_card_training.py -m cuda -q

Tolerances: those the port is held to against the JAX package on the CPU
(tests/test_torch_trajectory.py, a step that updates every parameter): the
two devices sum the same float32 products in other orders (cuDNN's and
cuBLAS's algorithms against the CPU's), and Adam's g/(|g| + ε) turns such
differences near g = 0 into ±lr updates. Metrics within rtol 5e-3;
parameters within atol 6e-3 (rtol 1e-3); a bias that feeds a BatchNorm has
no true gradient and random-walks on rounding noise: atol 4e-2; running
statistics atol 2e-2.
"""

import contextlib

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment

STEPS, BATCH, LR = 3, 4, 1e-3
METRIC_RTOL, PARAM_ATOL, CANCELLED_ATOL, STATS_ATOL = 5e-3, 6e-3, 4e-2, 2e-2
# tests/test_torch_compat.py's toy widths of the β-VAE-GAN
TOY = dict(n_hidden=16, n_z=[8, 4, 4], representation_size=4, head_width=32,
           decoder_channels=[8, 8, 8], disc_channels=[4, 8, 8, 8],
           disc_feature_dim=32, img_size=32)
# layers whose bias feeds a BatchNorm (tests/test_torch_trajectory.py)
BN_CANCELLED = {"conv1", "conv2", "conv3", "conv4", "mu_fc1", "lv_fc1",
                "preprocess", "deconv1", "deconv2", "deconv3"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@contextlib.contextmanager
def _tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _make(which):
    """(config, experiment class, batch, per-step draws) of one case."""
    rng = np.random.default_rng(0)
    if which == "mnist":
        cfg = Config(name="card_mnist", dataset="mnist", img_size=28,
                     input_channels=1, batch_size_train=BATCH,
                     dtype="float32", lr=LR, beta=1.0)
        x = (rng.uniform(0, 1, (BATCH, 28, 28, 1)) - 0.1307) / 0.3081
        z = 7 * 7 * 4
        draws = [{"labels": {"real": 0.9, "fake": 0.1},
                  "z_prior": rng.normal(size=(BATCH, z)),
                  "eps": rng.normal(size=(BATCH, z))} for _ in range(STEPS)]
        return cfg, FamilyExperiment, x, draws
    mode = which.split("_")[1]
    cfg = Config(name=f"card_{which}", batch_size_train=BATCH,
                 dtype="float32", lr=LR, beta=25.0, freeze_mode=mode, **TOY)
    x = rng.uniform(-1, 1, (BATCH, 32, 32, 3))
    draws = [{"labels": {"real": 0.9, "fake": 0.1},
              **{k: rng.normal(size=(BATCH, 16))
                 for k in ("noise", "eps_dec", "eps_enc")}}
             for _ in range(STEPS)]
    return cfg, VAEGANExperiment, x, draws


def _cancelled(name: str, which: str) -> bool:
    parts = name.split(".")
    if parts[-1] != "bias":
        return False
    if which == "mnist":
        return parts[-2].startswith("Conv_")
    return parts[-2] in BN_CANCELLED


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["betavaegan_observed", "betavaegan_intent",
                                   "mnist"])
def test_port_training_on_the_card_matches_the_cpu(card, which):
    cfg, make, x, draws = _make(which)
    runs = {}
    with _tf32_off():
        for dev in ("cpu", "cuda"):
            exp = make(cfg, dev)  # one seeded initialization on the host
            xt = torch.from_numpy(x.astype(np.float32)).to(dev)
            metrics = [{k: v.item() for k, v in exp.train_step(
                xt, draws={k: (v if k == "labels" else
                               np.asarray(v, np.float32))
                           for k, v in d.items()}).items()}
                       for d in draws]
            runs[dev] = (exp, metrics)
    (cpu, m_cpu), (gpu, m_gpu) = runs["cpu"], runs["cuda"]
    for step, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=METRIC_RTOL,
                                       err_msg=f"{which} step {step} {k}")
    for (name, p), (_, q) in zip(_modules(gpu), _modules(cpu)):
        atol = CANCELLED_ATOL if _cancelled(name, which) else PARAM_ATOL
        if "running_" in name:
            atol = STATS_ATOL
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().numpy(), rtol=1e-3, atol=atol,
                                   err_msg=f"{which} {name}")


def _modules(exp):
    nets = (exp.vae, exp.discriminator)
    for net in nets:
        yield from net.named_parameters()
        yield from net.named_buffers()
