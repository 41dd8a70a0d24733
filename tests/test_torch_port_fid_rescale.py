"""The FID path's per-image rescale, the port against the JAX package: an
expected difference, measured.

The port rescales by multiplying with the reciprocal of the floored range,
(x − lo)·(1/max(hi − lo, 1e-5)), as the TPU kernel does
(disentangle_mlp_tpu/ops/pallas/image_ops.py:31-32; the port's
``per_image_normalize`` and its plain version). The JAX package's FID path
divides, (x − lo)/max(hi − lo, 1e-5) (eval/fid.py:229-235), for the
Inception input and for the uint8 sample files (fid.py:374-376). Two
roundings against one: the results differ by at most 2 float32 ulps, and a
sample-file pixel by at most 1 level where x·255 + 0.5 lies within those
ulps of an integer.

Measured on FID_IMAGES seeded 64×64×3 decoder-like images (tanh outputs
rounded to bf16, as the sampling decode gives them, each in a range of its
own); printed by

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_fid_rescale
"""

import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from disentangle_mlp_tpu.eval.fid import _per_image_normalize_body
from disentangle_mlp_tpu_torch.eval.fid import (normalized_u8,
                                               per_image_normalize)

FID_IMAGES = 1000
MAX_ULPS, MAX_LEVELS = 2, 1


def images(n: int = FID_IMAGES, seed: int = 0) -> np.ndarray:
    """Decoder-like NHWC images in (−1, 1), bf16-rounded: tanh of seeded
    normals, each image scaled into a range of its own (a range that is a
    power of two rescales exactly both ways)."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.2, 1.0, (n, 1, 1, 1))
    x = (scale * np.tanh(rng.normal(size=(n, 64, 64, 3)))
         ).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def measure(x: np.ndarray) -> dict:
    """The port's FID path (on the CPU, its kernel's plain version) against
    the JAX FID path's division: the largest |Δ| in float32 ulps, and the
    uint8 sample-file pixels that differ."""
    jax_y = np.asarray(jax.jit(
        lambda b: _per_image_normalize_body(b, jnp))(jnp.asarray(x)))
    port_y = per_image_normalize(torch.from_numpy(x)).numpy()
    port_u8 = normalized_u8(torch.from_numpy(x)).numpy()
    # both lie in [0, 1]: their bit patterns order as the values do
    ulps = np.abs(jax_y.view(np.int32).astype(np.int64)
                  - port_y.view(np.int32).astype(np.int64))
    jax_u8 = np.clip(jax_y * 255.0 + 0.5, 0, 255).astype(np.uint8)
    levels = np.abs(jax_u8.astype(np.int16) - port_u8.astype(np.int16))
    return {"images": int(x.shape[0]), "values": int(x.size),
            "max_ulps": int(ulps.max()),
            "values_differing": int((ulps > 0).sum()),
            "max_levels": int(levels.max()),
            "pixels_differing": int((levels > 0).sum())}


def test_port_fid_rescale_is_within_two_ulps_of_the_jax_division():
    res = measure(images())
    assert res["max_ulps"] <= MAX_ULPS, res
    assert res["max_levels"] <= MAX_LEVELS, res


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(measure(images())))
