"""The port's per_image_normalize (disentangle_mlp_tpu_torch/ops/image_ops.py)
against the JAX package's Pallas kernel run in interpret mode and against
the JAX package's numpy FID preprocessing (eval/fid.py
``per_image_normalize``), plus the wrapper's refusals.

On the CPU the wrapper computes with the plain version, so these tests pin
the function the CUDA kernel must compute; chip_smoke.py holds the kernel
against the same plain version on the GPU.

Tolerance: outputs lie in [0, 1]. The Pallas body and the plain version
multiply by the reciprocal of the range, the numpy path divides by it, so
they may differ by an ulp or two of values ≤ 1: atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disentangle_mlp_tpu.eval.fid import \
    per_image_normalize as jax_numpy_normalize
from disentangle_mlp_tpu.ops.pallas.image_ops import \
    per_image_normalize_pallas
from disentangle_mlp_tpu_torch.eval import fid as port_fid
from disentangle_mlp_tpu_torch.ops import image_ops as pin

ATOL = 1e-6
SHAPES = ((4, 64, 64, 3), (3, 5, 7, 3))


def _images(shape, seed=0):
    """Values like the decoder's tanh output, each image its own range."""
    rng = np.random.default_rng(seed)
    x = np.tanh(2.0 * rng.normal(size=shape))
    return (x * rng.uniform(0.2, 1.0, size=(shape[0], 1, 1, 1))
            ).astype(np.float32)


def _port_input(x_np, dtype, layout):
    """The same values as a torch tensor of ``dtype``: contiguous NHWC, or
    the NHWC view of a contiguous NCHW tensor (what the decoder returns)."""
    t = torch.from_numpy(x_np).to(dtype)
    if layout == "nchw_view":
        t = t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not t.is_contiguous()
    return t


@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_port_per_image_normalize_matches_pallas_and_numpy(shape, dtype,
                                                           layout):
    x_np = _images(shape)
    x_t = _port_input(x_np, getattr(torch, dtype), layout)
    # both JAX references see exactly the values the port sees
    x_ref = x_t.float().contiguous().numpy()
    pallas = np.asarray(per_image_normalize_pallas(
        jnp.asarray(x_ref, getattr(jnp, dtype)), interpret=True))
    numpy_ref = jax_numpy_normalize(x_ref)

    before = pin.launches
    got = pin.per_image_normalize(x_t)
    assert pin.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got.shape == x_t.shape
    assert got.stride() == x_t.stride()
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), numpy_ref, rtol=0, atol=ATOL)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_port_per_image_normalize_constant_image_maps_to_zero():
    x_np = _images((3, 8, 8, 3), seed=1)
    x_np[1] = 0.25
    got = pin.per_image_normalize(torch.from_numpy(x_np)).numpy()
    pallas = np.asarray(per_image_normalize_pallas(jnp.asarray(x_np),
                                                   interpret=True))
    assert (got[1] == 0).all() and (pallas[1] == 0).all()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_port_per_image_normalize_propagates_nan_like_jax():
    """An image holding a NaN comes out all NaN (jnp.min/max propagate it),
    the other images untouched."""
    x_np = _images((3, 8, 8, 3), seed=2)
    x_np[2, 3, 4, 1] = np.nan
    got = pin.per_image_normalize(torch.from_numpy(x_np)).numpy()
    pallas = np.asarray(per_image_normalize_pallas(jnp.asarray(x_np),
                                                   interpret=True))
    assert np.isnan(got[2]).all() and np.isnan(pallas[2]).all()
    assert np.isfinite(got[:2]).all()
    np.testing.assert_allclose(got[:2], pallas[:2], rtol=0, atol=ATOL)


def test_port_fid_per_image_normalize_numpy_in_numpy_out():
    """eval.fid.per_image_normalize keeps numpy batches numpy (the plain
    version underneath) and tensors tensors."""
    x_np = _images((2, 6, 5, 3), seed=3)
    got = port_fid.per_image_normalize(x_np)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_numpy_normalize(x_np), rtol=0,
                               atol=ATOL)
    assert isinstance(port_fid.per_image_normalize(torch.from_numpy(x_np)),
                      torch.Tensor)


@pytest.mark.parametrize("make, dense", [
    (lambda: torch.zeros(4, 6, 5, 3), True),
    (lambda: torch.zeros(4, 3, 6, 5).permute(0, 2, 3, 1), True),
    (lambda: torch.zeros(1, 6, 5, 3), True),
    (lambda: torch.zeros(8, 6, 5, 3)[::2], False),       # images apart
    (lambda: torch.zeros(4, 6, 10, 3)[:, :, ::2], False),  # holes in one
    (lambda: torch.zeros(4, 6, 5, 1).expand(4, 6, 5, 3), False),  # overlap
    (lambda: torch.zeros(4, 6, 5, 6)[..., :3], False),
])
def test_port_per_image_normalize_layout_check(make, dense):
    assert pin._image_is_dense(make()) is dense


def test_port_per_image_normalize_refusals():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pin.per_image_normalize(torch.zeros(2, 4, 4, 3, dtype=torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pin.per_image_normalize(torch.zeros(2, 4, 4, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"\(N, H, W, C\)"):
        pin.per_image_normalize(torch.zeros(2, 48))
    with pytest.raises(ValueError, match="unsupported device"):
        pin.per_image_normalize(torch.zeros(2, 4, 4, 3, device="meta"))
    # the CUDA path checks dtype and layout before any build or launch
    before = pin.launches
    with pytest.raises(ValueError, match="one dense block"):
        pin._launch(torch.zeros(8, 4, 4, 3)[::2])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pin._launch(torch.zeros(2, 4, 4, 3, dtype=torch.float64))
    assert pin.launches == before


@pytest.mark.cuda
def test_port_per_image_normalize_kernel_matches_plain_on_cuda():
    """Runs only where a GPU is (python -m pytest -m cuda): the CUDA kernel
    against the plain version in both layouts and types, strides kept, at
    the CelebA FID path's 64×64 and the birds FID path's 128×128 (a float32
    image then stages 192 KB of shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with -m cuda on the GPU machine")
    for hw, dtype, layout in ((hw, dt, lay) for hw in (64, 128)
                              for dt in (torch.float32, torch.bfloat16)
                              for lay in ("nhwc", "nchw_view")):
        x = _port_input(_images((5, hw, hw, 3), seed=4), dtype,
                        layout).cuda()
        got = pin.per_image_normalize(x)
        want = pin.per_image_normalize_plain(x)
        torch.cuda.synchronize()
        assert got.stride() == x.stride()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=ATOL)
