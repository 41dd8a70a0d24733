"""What the data feed should hand the step, worked out apart from the
program: which images a step gets and their pixels, normalised to [-1, 1].

- The order: the trainer's loader shuffles each epoch with numpy's
  ``default_rng(seed + epoch).shuffle`` over the image indices and cuts
  whole batches (drop_last). Step s (from 1) is batch (s - 1) % steps
  of epoch (s - 1) // steps.
- ``synthetic``: the 'CelebA-like' stream of the program's
  ``--synthetic_data`` source, recomputed here in float64 from its
  definition: tanh of 16 hash-normal coefficients (/4) over a random
  basis, N(0, 1) from ``default_rng(seed)``, blurred by a circular
  Gaussian of sigma 6 * size / 64 pixels through the FFT and renormalised
  per pixel to unit variance.
- ``jpeg_tree``: file i of the tree is a copy of fixture i % n (the
  fixtures in sorted order); its pixels are the frozen libjpeg decode and
  PIL antialiased resize of the fixtures in ``fixtures_u8_64.npz`` (from
  ``disentangle_mlp_tpu_torch/data/fixtures/expected.npz``, ``u8_64``,
  the 14 colour files of CelebA's geometry), u8 * 2 / 255 - 1.
"""

from __future__ import annotations

import fnmatch
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
JPEG_DIR = HERE / "jpeg"


def order(n: int, batch: int, seed: int, step: int) -> np.ndarray:
    """The image indices of step ``step`` (from 1)."""
    per_epoch = n // batch
    epoch, j = divmod(step - 1, per_epoch)
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx[j * batch:(j + 1) * batch]


def _hash_normal(idx: np.ndarray, seed: int) -> np.ndarray:
    j = np.arange(16, dtype=np.uint64)

    def h(salt):
        v = (idx[:, None].astype(np.uint64) * np.uint64(2654435761)
             + j[None, :] * np.uint64(40503)
             + np.uint64(seed * 7919 + salt))
        v ^= v >> np.uint64(33)
        v *= np.uint64(0xFF51AFD7ED558CCD)
        v ^= v >> np.uint64(33)
        return ((v & np.uint64(0xFFFFFFFF)).astype(np.float64) + 0.5) / 2**32

    return np.sqrt(-2.0 * np.log(h(1))) * np.cos(2.0 * np.pi * h(2))


def _basis(size: int, channels: int, seed: int) -> np.ndarray:
    b = np.random.default_rng(seed).normal(size=(16, size, size, channels))
    f = np.fft.fftfreq(size)
    g = np.exp(-2.0 * (np.pi * (6.0 * size / 64.0) * f) ** 2)
    spec = np.fft.fft2(b, axes=(1, 2))
    spec *= g[None, :, None, None] * g[None, None, :, None]
    b = np.fft.ifft2(spec, axes=(1, 2)).real
    return b / np.maximum(np.sqrt((b ** 2).mean(axis=0, keepdims=True)),
                          1e-8)


def synthetic(idx: np.ndarray, size: int, channels: int, seed: int
              ) -> np.ndarray:
    coeff = _hash_normal(np.asarray(idx, np.int64), seed) / 4.0
    return np.tanh(np.tensordot(coeff, _basis(size, channels, seed), 1))


def fixtures(patterns: List[str]) -> List[str]:
    return sorted(p.name for p in JPEG_DIR.iterdir()
                  if any(fnmatch.fnmatch(p.name, pat) for pat in patterns))


def jpeg_tree(idx: np.ndarray, patterns: List[str]) -> np.ndarray:
    with np.load(HERE / "fixtures_u8_64.npz") as f:
        names, u8 = list(f["names"]), f["u8_64"]
    files = fixtures(patterns)
    rows = [names.index(files[i % len(files)]) for i in np.asarray(idx)]
    return u8[rows].astype(np.float64) * (2.0 / 255.0) - 1.0


def batch(feed: Dict, img_size: int, channels: int, batch_size: int,
          seed: int, step: int) -> np.ndarray:
    """The (B, H, W, C) float64 batch of step ``step`` of ``feed`` (a
    cell's ``feed`` entry) under the loader seed ``seed``."""
    idx = order(feed["size"], batch_size, seed, step)
    if feed["source"] == "synthetic":
        return synthetic(idx, img_size, channels, seed)
    if feed["source"] == "jpeg_tree":
        if img_size != 64:
            raise ValueError("the frozen decode of the fixtures is 64x64")
        return jpeg_tree(idx, feed["fixtures"])
    raise ValueError(f"unknown feed source {feed['source']!r}")
