"""Sample and reconstruction image dumpers (disentangle_mlp_tpu/eval/samples.py;
reference utils/utils.py:6-32), with the same file names:

- ``generate_fid_samples``: z ~ N(0, 1) → fn(z) → one ``sample_{i}_{epoch}.png``
  per image;
- ``generate_samples``: one grid ``sample_{epoch}.png``;
- ``gen_reconstructions``: the first test batch → fn → grid
  ``recon_{epoch}.png`` (+ an originals grid);
- ``gen_fid_reconstructions``: one ``recon_{i}_{epoch}.png`` per image.

``fn`` is any tensor → tensor callable on NHWC images (the experiment's
decode in training). Latents come from a ``torch.Generator`` seeded with
``rng_seed`` on ``device``, or are passed in (``z=``), which the tests do to
feed both packages the same draws. Extension .png, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..utils import runtime
from ..utils.image_io import save_image, save_image_grid, write_png


def _sample_latents(rng_seed: int, n_samples: int, n_hidden: int,
                    device="cuda") -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(rng_seed)
    return torch.randn((n_samples, n_hidden), generator=gen, device=device)


def _host(batch) -> np.ndarray:
    """A host numpy copy: uint8 stays uint8, other tensors become float32
    (numpy has no bfloat16)."""
    if isinstance(batch, torch.Tensor):
        t = batch.detach().cpu()
        return (t if t.dtype == torch.uint8 else t.float()).numpy()
    return np.asarray(batch)


def write_sample_files(u8_batch, epoch: int, results_path: str,
                       prefix: str = "sample") -> None:
    """One ``{prefix}_{i}_{epoch}.png`` per image of an already quantized
    NHWC uint8 batch (eval.fid.normalized_u8); safe to call from a
    background thread with a host array, which the train loop does."""
    for i, arr in enumerate(_host(u8_batch)):
        write_png(f"{results_path}/{prefix}_{i}_{epoch}.png", arr)


def generate_fid_samples(fn: Callable, epoch: int, n_samples: int,
                         n_hidden: int, results_path: str,
                         rng_seed: int = 0, save: bool = True,
                         device="cuda", z: Optional[torch.Tensor] = None):
    """Decode ``n_samples`` latents and (with ``save``) write one PNG per
    image; returns the decoded batch, on the decode's device, for scoring
    in memory."""
    from .fid import normalized_u8

    if z is None:
        z = _sample_latents(rng_seed, n_samples, n_hidden, device)
    with runtime.span("dmt.fid.decode"):
        out = fn(z)
    if save:
        write_sample_files(normalized_u8(out), epoch, results_path)
    return out


def generate_samples(fn: Callable, epoch: int, n_samples: int, n_hidden: int,
                     results_path: str, nrow: int = 8, rng_seed: int = 0,
                     device="cuda", z: Optional[torch.Tensor] = None) -> None:
    """Grid of decoded samples (utils.py:28-32)."""
    if z is None:
        z = _sample_latents(rng_seed, n_samples, n_hidden, device)
    save_image_grid(_host(fn(z)), f"{results_path}/sample_{epoch}.png",
                    nrow=nrow)


def gen_reconstructions(fn: Callable, dl: Iterable, epoch: int,
                        results_path: str, nrow: int = 8,
                        path_for_originals: str = "") -> None:
    """Reconstruct the first test batch into a grid (utils.py:13-19)."""
    orig, _ = next(iter(dl))
    save_image_grid(_host(fn(orig)), f"{results_path}/recon_{epoch}.png",
                    nrow=nrow)
    if path_for_originals:
        save_image_grid(_host(orig),
                        f"{path_for_originals}/original_{epoch}.png",
                        nrow=nrow)


def gen_fid_reconstructions(fn: Callable, dl: Iterable, epoch: int,
                            results_path: str) -> None:
    """Per-image reconstruction files (utils.py:6-11)."""
    orig, _ = next(iter(dl))
    batch = _host(fn(orig))
    for i in range(batch.shape[0]):
        save_image(batch[i], f"{results_path}/recon_{i}_{epoch}.png",
                   normalize=True)
