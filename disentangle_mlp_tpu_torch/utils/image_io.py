"""Image saving: single images and grids, as PNG files
(disentangle_mlp_tpu/utils/image_io.py, the reference's torchvision
``save_image`` usage in utils/utils.py:6-32).

``normalize=True`` rescales each saved array from its own [min, max] to
[0, 255]; grids are rows of ``nrow`` with 2-pixel padding. PNGs are
written by :func:`write_png`, a small encoder on the standard library's
``zlib`` (8-bit grey or RGB, filter 0, no interlace), so the files need no
imaging package.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels → PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write an HW or HWC (C = 1 or 3) uint8 array as a PNG file."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png: uint8 array needed, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"write_png: HW, HW1 or HW3 array needed, got shape "
                         f"{arr.shape}")
    h, w, c = arr.shape
    # each scanline: filter byte 0, then the row's samples
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _to_uint8(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    """HWC float → HWC uint8. With normalize, rescale from the array's own
    range (torchvision save_image(normalize=True) semantics)."""
    img = np.asarray(img, np.float32)
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-5)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(img, path: str, normalize: bool = True) -> None:
    """Save one HWC image (any float range)."""
    write_png(path, _to_uint8(np.asarray(img), normalize))


def make_grid(batch: np.ndarray, nrow: int = 8, padding: int = 2,
              normalize: bool = True) -> np.ndarray:
    """NHWC batch → one HWC grid image (torchvision make_grid layout)."""
    batch = np.asarray(batch, np.float32)
    n, h, w, c = batch.shape
    if normalize:
        lo, hi = float(batch.min()), float(batch.max())
        batch = (batch - lo) / max(hi - lo, 1e-5)
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = batch[i]
    return grid


def save_image_grid(batch, path: str, nrow: int = 8,
                    normalize: bool = True) -> None:
    grid = make_grid(np.asarray(batch), nrow=nrow, normalize=normalize)
    write_png(path, np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8))
