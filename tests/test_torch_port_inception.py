"""The port's FID InceptionV3 (disentangle_mlp_tpu_torch/eval/inception.py)
and its parameter bridge (utils/params.py ``inception_from_jax``) against
the JAX package's (disentangle_mlp_tpu/eval/inception.py), on the CPU in
float32.

Both packages load one parameter tree (HWIO kernels with BatchNorm folded
in), so the same tree goes through both forwards. The pool3 tolerance is
that of tests/test_inception_parity.py (rtol 2e-3, atol 2e-4): 94
convolutions summed in different orders by XLA and PyTorch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from disentangle_mlp_tpu.eval import inception as jax_inception
from disentangle_mlp_tpu_torch.eval import inception as port_inception
from disentangle_mlp_tpu_torch.utils.params import (inception_from_jax,
                                                    inception_to_jax)
from tests.test_inception_parity import TorchFIDInception

POOL3_TOL = dict(rtol=2e-3, atol=2e-4)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def params():
    """The port's seeded random fallback tree (numpy), which both packages'
    forwards accept."""
    return port_inception.init_random_params(seed=0)


@pytest.fixture(scope="module")
def model(params):
    return inception_from_jax(params)


@pytest.fixture(scope="module")
def torch_fid_state(tmp_path_factory):
    """A pt_inception-layout checkpoint (conv + BatchNorm per layer) with
    random weights and BatchNorm statistics, saved once per module."""
    net = TorchFIDInception()
    g = torch.Generator().manual_seed(1)
    sd = net.state_dict()
    for k, v in sd.items():
        if k.endswith("running_var") or ".bn.weight" in k:
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.dtype.is_floating_point:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    net.load_state_dict(sd)
    path = tmp_path_factory.mktemp("fid_weights") / "fid_inception.pth"
    torch.save(net.state_dict(), path)
    return net.eval(), str(path)


def test_port_inception_spec_is_the_jax_packages():
    assert port_inception.INCEPTION_SPEC == jax_inception.INCEPTION_SPEC
    assert port_inception.FEATURE_DIM == jax_inception.FEATURE_DIM


def test_port_inception_from_jax_round_trip_is_exact(params, model):
    back = dict(_leaves(inception_to_jax(model)))
    want = dict(_leaves(params))
    assert sorted(back) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)
    # kernels land as OIHW weights
    k = params["Mixed_6b"]["branch7x7_2"]["kernel"]  # (1, 7, c7, c7) HWIO
    w = model.Mixed_6b["branch7x7_2"].weight
    assert tuple(w.shape) == (k.shape[3], k.shape[2], k.shape[0], k.shape[1])


def test_port_pool3_matches_jax_on_carried_params(params, model):
    """2 images at 64×64: the production bilinear resize to 299, then the
    network, in both packages on one tree."""
    imgs01 = np.random.default_rng(2).uniform(
        0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_inception.pool3_features(
        params, jnp.asarray(imgs01), dtype=jnp.float32))
    got = port_inception.pool3_features(model, torch.from_numpy(imgs01))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want, **POOL3_TOL)


def test_port_load_torch_fid_weights_matches_jax(torch_fid_state):
    _, path = torch_fid_state
    port = dict(_leaves(port_inception.load_torch_fid_weights(path)))
    jax_tree = dict(_leaves(jax_inception.load_torch_fid_weights(path)))
    assert sorted(port) == sorted(jax_tree)
    for name, leaf in jax_tree.items():
        assert port[name].dtype == np.float32
        np.testing.assert_array_equal(port[name], leaf, err_msg=name)


def test_port_pool3_matches_independent_torch_build(torch_fid_state):
    """The folded-BN port against the conv + BatchNorm network whose
    checkpoint it loaded, on the resize path (resize, then 2x − 1)."""
    net, path = torch_fid_state
    model = inception_from_jax(port_inception.load_torch_fid_weights(path))
    imgs01 = np.random.default_rng(7).uniform(
        0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        x = F.interpolate(torch.from_numpy(imgs01).permute(0, 3, 1, 2),
                          size=(299, 299), mode="bilinear",
                          align_corners=False)
        want = net(x * 2.0 - 1.0).numpy()
    got = port_inception.pool3_features(model, torch.from_numpy(imgs01))
    np.testing.assert_allclose(got.numpy(), want, **POOL3_TOL)


def test_port_random_fallback_is_seeded_he_normal():
    a = port_inception.init_random_params(seed=5)
    b = port_inception.init_random_params(seed=5)
    c = port_inception.init_random_params(seed=6)
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)
    k = a["Mixed_7c"]["branch3x3dbl_2"]["kernel"]
    assert not np.array_equal(k, c["Mixed_7c"]["branch3x3dbl_2"]["kernel"])
    kh, kw, cin, _ = k.shape
    np.testing.assert_allclose(k.std(), np.sqrt(2.0 / (kh * kw * cin)),
                               rtol=0.02)
    assert all(not leaf.any() for name, leaf in _leaves(a)
               if name.endswith("bias"))


def test_port_pool3_turns_cudnn_tf32_off_and_restores_it(model):
    """The float32 contract: cuDNN's TF32 is off inside the forward and
    the caller's setting is back afterwards."""
    seen = []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    hook = model.Conv2d_1a_3x3.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    try:
        port_inception.pool3_features(model, torch.zeros(1, 75, 75, 3))
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = prev
