"""Fréchet Inception Distance of the port (disentangle_mlp_tpu/eval/fid.py).

- pool3 features come from the port's InceptionV3 (eval/inception.py) on
  the images' device, in float32 with TF32 off unless asked otherwise;
- decoded samples are scored in memory (``get_fid_from_samples``), after
  the per-image min-max rescale the sample files get
  (torchvision ``save_image(normalize=True)``), so in-memory and on-disk
  scores agree up to uint8 rounding. On CUDA tensors that rescale is the
  hand-written ``per_image_normalize`` kernel (ops/image_ops.py);
- tr√(Σ₁Σ₂) is computed on the host in float64 with symmetric
  eigendecompositions, exactly as in the JAX package;
- reference statistics are ``.npz`` archives holding ``mu`` and ``sigma``,
  or a directory of images, whose statistics are computed on the way
  (``statistics_from_dir``: JPEGs decoded on the device by data/native.py,
  PNGs by utils/image_io.read_png); ``get_fid`` scores one against the
  other, the reference's public signature;
- under a mesh (parallel/mesh.py) :func:`get_activations` splits the
  samples over the ranks: each rank normalizes and runs pool3 on its
  contiguous slice only, and the ranks' activations are gathered, as the
  JAX package shards them over its devices.
"""

from __future__ import annotations

import functools
import os
import pathlib
import zipfile
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops.image_ops import per_image_normalize as _normalize_tensor
from ..parallel.mesh import all_gather_rows
from ..utils.params import inception_from_jax
from .inception import FEATURE_DIM, get_params_cached, pool3_features

FID_BATCH = 100

# Compute dtype of pool3 feature extraction: float32 by default (bf16
# rounding through 94 convolutions is drift the FID tolerance has no room
# for); DMT_FID_DTYPE=bfloat16 opts into bf16 for throughput-bound scoring.
FEATURE_DTYPE = os.environ.get("DMT_FID_DTYPE", "float32")

Images = Union[torch.Tensor, np.ndarray]


@functools.lru_cache(maxsize=2)
def _inception(device: str):
    """The InceptionV3 of ``get_params_cached`` on ``device``, built once."""
    params, _ = get_params_cached()
    return inception_from_jax(params).to(device)


def inception_is_pretrained() -> bool:
    return get_params_cached()[1]


def get_activations(images01: Images, batch_size: int = FID_BATCH,
                    dtype: Optional[str] = None,
                    device: str = "cuda", mesh=None,
                    normalize: bool = False) -> np.ndarray:
    """NHWC float images in [0, 1] → (N, 2048) float32 activations, in
    chunks of ``batch_size``. A tensor is processed on its own device; a
    numpy batch is moved to ``device`` first. ``dtype`` overrides the
    extraction dtype (default FEATURE_DTYPE, float32). ``normalize``: the
    images are raw decodes, per-image normalized here first.

    Under a joined ``mesh`` every rank passes all N images; each takes its
    contiguous ⌈N/W⌉ rows (the last rank's padded with zeros), normalizes
    and extracts only those, and every rank gets all N activations back
    (:func:`all_gather_rows`), as the JAX package's sharded extraction
    gives (pool3 is per image)."""
    if not isinstance(images01, torch.Tensor):
        images01 = torch.from_numpy(np.asarray(images01, np.float32)).to(
            device)
    n = images01.shape[0]
    if mesh is not None:
        per = -(-n // mesh.size)
        images01 = images01[mesh.rank * per:(mesh.rank + 1) * per]
        pad = per - images01.shape[0]
        if pad:
            images01 = torch.cat([images01, images01.new_zeros(
                (pad,) + tuple(images01.shape[1:]))])
    if normalize:
        images01 = _normalize_tensor(images01)
    model = _inception(str(images01.device))
    feat_dtype = getattr(torch, dtype or FEATURE_DTYPE)
    acts = [pool3_features(model, images01[i:i + batch_size], feat_dtype)
            for i in range(0, images01.shape[0], batch_size)]
    if not acts:
        return np.empty((0, FEATURE_DIM), np.float32)
    out = torch.cat(acts)
    if mesh is not None:
        out = all_gather_rows(out, mesh)[:n]
    return out.cpu().numpy()


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """μ and Σ (ddof=1) of pool3 activations in float64, Σ as one gemm on
    the centred matrix."""
    acts = acts.astype(np.float64)
    mu = acts.mean(axis=0)
    xc = acts - mu
    sigma = xc.T @ xc / (acts.shape[0] - 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 0.0) -> float:
    """d² = |μ₁−μ₂|² + Tr(Σ₁ + Σ₂ − 2√(Σ₁Σ₂)), with
    tr√(Σ₁Σ₂) = tr√(√Σ₁ Σ₂ √Σ₁) from symmetric eigendecompositions
    (negative eigenvalues from rounding clipped; ``eps`` adds diagonal
    jitter to Σ₁, kept for the reference's signature)."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different dimensions: mu "
                         f"{mu1.shape} vs {mu2.shape}, sigma {sigma1.shape} "
                         f"vs {sigma2.shape}")

    diff = mu1 - mu2
    s1j = sigma1 if eps == 0.0 else sigma1 + eps * np.eye(sigma1.shape[0])
    w1, v1 = np.linalg.eigh(s1j)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt_s1 @ sigma2 @ sqrt_s1
    w = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_covmean = float(np.sum(np.sqrt(np.clip(w, 0.0, None))))

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def _sqrt_psd(sigma: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh (tiny negative eigenvalues from
    rounding clipped, as in frechet_distance)."""
    w, v = np.linalg.eigh(np.asarray(sigma, np.float64))
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


# √Σ₂ of the run's reference statistics, memoized on the stats file's
# identity (path, mtime, size): Σ₂ is fixed across a run's epochs, so the
# full-stats path spends one eigvalsh per epoch instead of two
# decompositions. One entry: a process scores against one file at a time.
_SQRT2_CACHE: dict = {}


def cached_sqrt_sigma2(path: str, sigma2: np.ndarray) -> Optional[np.ndarray]:
    """√Σ₂ for ``path``'s reference stats, memoized while the .npz file is
    unchanged (None for other paths or a file that cannot be stat'ed)."""
    if not path.endswith(".npz"):
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    hit = _SQRT2_CACHE.get(key)
    if hit is None:
        _SQRT2_CACHE.clear()
        hit = _SQRT2_CACHE[key] = _sqrt_psd(sigma2)
    return hit


def frechet_distance_from_samples(acts: np.ndarray, mu2: np.ndarray,
                                  sigma2: np.ndarray) -> float:
    """FID between a sample of activations (n × d) and reference stats,
    exact, in the sample's n-dimensional subspace: the nonzero eigenvalues
    of Σ₁Σ₂ are those of the PSD n×n matrix Xc Σ₂ Xcᵀ/(n−1), so
    tr√(Σ₁Σ₂) needs one n×n eigvalsh."""
    acts = acts.astype(np.float64)
    n = acts.shape[0]
    mu1 = acts.mean(axis=0)
    xc = acts - mu1
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    a = xc @ sigma2 @ xc.T / (n - 1)
    w = np.linalg.eigvalsh((a + a.T) / 2.0)
    tr_covmean = float(np.sum(np.sqrt(np.clip(w, 0.0, None))))

    diff = mu1 - mu2
    tr_sigma1 = float(np.sum(xc * xc)) / (n - 1)
    return float(diff @ diff + tr_sigma1 + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def frechet_from_acts(acts: np.ndarray, mu2: np.ndarray,
                      sigma2: np.ndarray,
                      sqrt_sigma2: Optional[np.ndarray] = None) -> float:
    """The host half of sample scoring: pool3 activations → FID. Fewer
    samples than feature dimensions take the sample-subspace path;
    otherwise the full statistics, where a precomputed ``sqrt_sigma2``
    gives tr√(Σ₁Σ₂) = tr√(√Σ₂ Σ₁ √Σ₂) with one eigvalsh."""
    if acts.shape[0] < FEATURE_DIM:
        return frechet_distance_from_samples(acts, mu2, sigma2)
    m1, s1 = activation_statistics(acts)
    if sqrt_sigma2 is None:
        return frechet_distance(m1, s1, mu2, sigma2)
    diff = np.asarray(m1, np.float64) - np.asarray(mu2, np.float64)
    inner = sqrt_sigma2 @ np.asarray(s1, np.float64) @ sqrt_sigma2
    w = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_covmean = float(np.sum(np.sqrt(np.clip(w, 0.0, None))))
    return float(diff @ diff + np.trace(s1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def per_image_normalize(batch: Images) -> Images:
    """Per-image min-max → [0, 1] float32 (torchvision
    ``save_image(normalize=True)`` semantics). A CUDA tensor goes through
    the kernel and stays on the device; a CPU tensor or a numpy array
    through the kernel's plain version (numpy in, numpy out)."""
    if isinstance(batch, torch.Tensor):
        return _normalize_tensor(batch)
    return _normalize_tensor(torch.from_numpy(
        np.asarray(batch, np.float32))).numpy()


def normalized_u8(batch: Images) -> Images:
    """Per-image min-max → uint8 (the sample files' pixels):
    clip(x·255 + 0.5, 0, 255) truncated, as image_io._to_uint8 does. A
    device batch stays on the device, so the host pulls n·H·W·C bytes for
    the PNG files instead of four times that in float32."""
    y = per_image_normalize(batch)
    if isinstance(y, torch.Tensor):
        return torch.clamp(y * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)


class StatsFileError(ValueError):
    """The reference-statistics file exists but is not a usable {mu, sigma}
    archive: an asset problem (the train loop degrades FID to 'N/A' on it,
    as for a missing file), not a programming error."""


# The "missing, unreadable or corrupt asset" conditions under which
# per-epoch FID degrades to 'N/A' instead of ending training. Only these:
# anything else in the FID stack is a programming error and re-raises.
ASSET_ERRORS = (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                PermissionError, zipfile.BadZipFile, StatsFileError)


def load_stats_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as f:
        try:
            return f["mu"][:], f["sigma"][:]
        except KeyError as e:
            raise StatsFileError(
                f"{path!r} lacks the mu/sigma arrays (has: "
                f"{sorted(f.files)})") from e


def statistics_from_dir(path: str, batch_size: int = FID_BATCH,
                        device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Directory of *.jpg, then *.png files (each sorted) → (μ, Σ), as the
    JAX package computes them (its eval/fid.py:276-316; reference
    fid.py:68-105): each image at its native resolution, divided by 255,
    ``batch_size`` images at a time through pool3 on ``device``, so memory
    stays O(batch + d²) whatever the directory's size. μ and Σ come from
    float64 sums Σx and Σxxᵀ; Σ is the ddof=1 covariance of
    :func:`activation_statistics` to float64 rounding. JPEGs are decoded on
    ``device`` (nvJPEG on the card, libjpeg on the CPU), PNGs on the host;
    the images of one batch must share a size."""
    from ..data import native

    files = sorted(pathlib.Path(path).glob("*.jpg")) + \
        sorted(pathlib.Path(path).glob("*.png"))
    if not files:
        raise FileNotFoundError(f"no *.jpg/*.png under {path!r}")
    n = len(files)
    if n < 2:
        raise ValueError(f"need ≥2 images for covariance, got {n}")
    s = np.zeros(FEATURE_DIM, np.float64)
    ss = np.zeros((FEATURE_DIM, FEATURE_DIM), np.float64)
    for start in range(0, n, batch_size):
        names = [str(f) for f in files[start:start + batch_size]]
        imgs = native.decode(native.read_files(names), names, device)
        if len({tuple(im.shape) for im in imgs}) > 1:
            raise ValueError(f"{path!r}: images of different sizes in one "
                             f"batch of {batch_size}: "
                             f"{sorted({tuple(im.shape) for im in imgs})}")
        x01 = torch.stack(imgs).to(torch.float32) / 255.0
        acts = get_activations(x01, batch_size=batch_size).astype(np.float64)
        s += acts.sum(axis=0)
        ss += acts.T @ acts
    mu = s / n
    sigma = (ss - n * np.outer(mu, mu)) / (n - 1)
    return mu, sigma


def _handle_path(path: str, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Reference statistics: a .npz file, or those of an image directory
    computed on ``device``."""
    if path.endswith(".npz"):
        return load_stats_npz(path)
    return statistics_from_dir(path, device=device)


def get_fid(path_data: str, path_pretrained: str, device="cuda") -> float:
    """The reference's public signature (fid.py:320-323; JAX package
    eval/fid.py:325-331): FID between a directory of images (or a .npz of
    statistics) and the reference statistics (or a directory of images)."""
    m1, s1 = _handle_path(path_data, device)
    m2, s2 = _handle_path(path_pretrained, device)
    return frechet_distance(m1, s1, m2, s2)


def get_fid_from_samples(samples_pm1: Images, path_pretrained: str,
                         mesh=None) -> float:
    """Score decoded samples (NHWC, any range; per-image normalized here)
    against reference stats, in memory; under a ``mesh`` every rank holds
    all the samples and extracts its slice (:func:`get_activations`)."""
    device = samples_pm1.device if isinstance(samples_pm1, torch.Tensor) \
        else "cuda"
    m2, s2 = _handle_path(path_pretrained, device)
    acts = get_activations(samples_pm1, device=device, mesh=mesh,
                           normalize=True)
    sqrt2 = (cached_sqrt_sigma2(path_pretrained, s2)
             if acts.shape[0] >= FEATURE_DIM else None)
    return frechet_from_acts(acts, m2, s2, sqrt_sigma2=sqrt2)


def compute_dataset_statistics(loader, path_out: Optional[str] = None,
                               max_images: int = 50000
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference statistics from a loader of [-1, 1] NHWC batches (the
    tool that makes fid_stats_celeba.npz-equivalents). Batches stay on the
    loader's device; written to ``path_out`` as {mu, sigma} when given."""
    feats = []
    seen = 0
    for x, _ in loader:
        feats.append(get_activations((x.float() + 1.0) / 2.0))
        seen += x.shape[0]
        if seen >= max_images:
            break
    mu, sigma = activation_statistics(np.concatenate(feats)[:max_images])
    if path_out:
        np.savez(path_out, mu=mu, sigma=sigma)
    return mu, sigma
