"""Data feed of the port (disentangle_mlp_tpu/data/pipeline.py), the part
the β-VAE-GAN slice uses:

- :class:`SyntheticSource`, the deterministic 'CelebA-like' image stream,
  numerically identical to the JAX package's (same hash normals, same
  blurred basis, same tanh);
- :class:`DataLoader`, the float path: a seeded numpy shuffle per epoch,
  drop_last batching, float32 NHWC host batches moved to the device;
- :func:`get_data_loader`, the celebA branch with synthetic data.

Image folders, MNIST and the native decoder are not ported yet: asking for
real data raises.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

# Materialize a synthetic dataset in host RAM when it fits this budget
# (the JAX package's DMT_DECODE_CACHE_BYTES default); bigger sets are
# computed batch by batch.
CACHE_BYTES = 4 * 1024 ** 3


class SyntheticSource:
    """Deterministic synthetic images: tanh of 16 hash-normal coefficients
    over a Gaussian-blurred random basis, in [-1, 1], celebA's normalized
    range (identical to the JAX package's SyntheticSource with its default
    normalization, which explains the blur)."""

    def __init__(self, size: int = 4096, img_size: int = 64,
                 channels: int = 3, seed: int = 0,
                 basis_sigma: Optional[float] = None):
        self.size = size
        self.img_size = img_size
        self.channels = channels
        self.seed = seed
        if basis_sigma is None:
            basis_sigma = 6.0 * img_size / 64.0
        self.basis_sigma = float(basis_sigma)
        rng = np.random.default_rng(seed)
        b = rng.normal(size=(16, img_size, img_size, channels))
        if self.basis_sigma > 0.0:
            # circular Gaussian blur via FFT: transfer exp(-2π²σ²f²)
            f = np.fft.fftfreq(img_size)
            g = np.exp(-2.0 * (np.pi * self.basis_sigma * f) ** 2)
            spec = np.fft.fft2(b, axes=(1, 2))
            spec *= g[None, :, None, None] * g[None, None, :, None]
            b = np.fft.ifft2(spec, axes=(1, 2)).real
            # per-pixel renormalize so Var(z_p) stays ~1
            ss = np.sqrt((b ** 2).sum(axis=0, keepdims=True) / b.shape[0])
            b = b / np.maximum(ss, 1e-8)
        self._basis = b.astype(np.float32)
        self._use_cache = size * img_size * img_size * channels * 4 \
            <= CACHE_BYTES
        self._cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.size

    @staticmethod
    def _hash_normal(idx: np.ndarray, j: np.ndarray, seed: int) -> np.ndarray:
        """Per-(index, coefficient) standard normals by integer hashing and
        Box–Muller."""
        def h(salt):
            v = (idx[:, None].astype(np.uint64) * np.uint64(2654435761)
                 + j[None, :].astype(np.uint64) * np.uint64(40503)
                 + np.uint64(seed * 7919 + salt))
            v ^= v >> np.uint64(33)
            v *= np.uint64(0xFF51AFD7ED558CCD)
            v ^= v >> np.uint64(33)
            return ((v & np.uint64(0xFFFFFFFF)).astype(np.float64) + 0.5) / 2**32
        u1, u2 = h(1), h(2)
        return (np.sqrt(-2.0 * np.log(u1))
                * np.cos(2.0 * np.pi * u2)).astype(np.float32)

    def _materialize(self, idx: np.ndarray) -> np.ndarray:
        coeff = self._hash_normal(idx, np.arange(16), self.seed) / 4.0
        return np.tanh(np.tensordot(coeff, self._basis, axes=1)
                       ).astype(np.float32)

    def load_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        if self._use_cache:
            if self._cache is None:
                self._cache = self._materialize(np.arange(self.size))
            out = self._cache[idx]
        else:
            out = self._materialize(idx)
        return out, (idx % 2).astype(np.int32)


class DataLoader:
    """Shuffling, drop_last batching loader yielding (images, labels) as
    tensors on ``device``: images NHWC float32, labels int32."""

    def __init__(self, source, batch_size: int, shuffle: bool = False,
                 seed: int = 999, device="cuda"):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device)
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.source) // self.batch_size  # drop_last

    @property
    def dataset_size(self) -> int:
        return len(self.source)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.source))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        idx = self._epoch_indices()
        self._epoch += 1
        for i in range(len(self)):
            x, y = self.source.load_batch(
                idx[i * self.batch_size:(i + 1) * self.batch_size])
            yield (torch.from_numpy(x).to(self.device),
                   torch.from_numpy(y).to(self.device))


def get_data_loader(opt, device="cuda"):
    """(train, val, test) loaders for celebA, with synthetic data when
    ``opt.synthetic_data`` is set or the image roots are absent (the JAX
    package's get_data_loader contract)."""
    if opt.dataset not in ("celebA", "celebA_reduced"):
        raise NotImplementedError(
            f"dataset {opt.dataset!r} is not ported yet (celebA only)")

    def make(root: str, batch: int, shuffle: bool, split_seed: int):
        if not opt.synthetic_data and os.path.isdir(root):
            raise NotImplementedError(
                f"image-folder data ({root!r}) is not ported yet; pass "
                f"--synthetic_data True")
        n = opt.synthetic_train_size if shuffle else \
            max(opt.batch_size_test * 4, 64)
        sig = float(opt.synthetic_basis_sigma)
        src = SyntheticSource(size=n, img_size=opt.img_size,
                              channels=opt.input_channels,
                              seed=opt.seed + split_seed,
                              basis_sigma=None if sig < 0 else sig)
        return DataLoader(src, batch, shuffle=shuffle, seed=opt.seed,
                          device=device)

    train = make(opt.image_root_train, opt.batch_size_train, True, 0)
    val = make(opt.image_root_val, opt.batch_size_val, False, 1)
    test = make(opt.image_root_test, opt.batch_size_test, False, 2)
    return train, val, test
